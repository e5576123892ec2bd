"""Gemma and Gemma 2 causal LMs with named activation taps.

Counterpart of ``semanticlens_tpu.models.gemma``. Google's recipe on the
Llama skeleton (``models/llama.py``):

- RMSNorm with a (1 + w) scale and zero-initialised weights (HF
  ``GemmaRMSNorm``), the weight shifted at call time so checkpoints load
  as they are;
- the embedding multiplied by ``sqrt(width)`` in the activation dtype,
  through ``channel_scale`` (ε rule under LRP);
- a GeGLU MLP, ``down(gelu_tanh(gate(x)) · up(x))``;
- head_dim decoupled from width (256), multi-query attention on Gemma-2B.

Gemma 2 adds sandwich norms (``post_attention_layernorm`` normalises the
attention output before its residual add; ``pre_/post_feedforward_layernorm``
wrap the MLP), tanh soft caps on the attention logits (50) and the final
logits (30, in float32), a ``query_pre_attn_scalar`` attention scale, and a
sliding window on even layers. ``lm_head`` taps the logits before the final
cap. Names follow HF ``GemmaForCausalLM`` / ``Gemma2ForCausalLM``.
"""

from __future__ import annotations

import torch

from semanticlens_tpu_torch.models.layers import channel_scale, gelu, residual_add, rms_norm
from semanticlens_tpu_torch.models.llama import Llama


class Gemma(Llama):
    """Gemma-1 causal LM, HF ``GemmaForCausalLM`` names, (B, T) integer tokens.

    Takes the Llama constructor arguments (``head_dim`` decoupled from
    ``width // heads``); word embeddings are always tied.
    """

    # HF zoo: name → ctor kwargs (the checkpoints' config.json)
    _HF_VARIANTS = {
        "gemma-2b": dict(
            vocab_size=256000, n_positions=8192, width=2048, depth=18, heads=8,
            kv_heads=1, head_dim=256, intermediate=16384, rope_theta=1e4,
            rms_eps=1e-6),
        "gemma-7b": dict(
            vocab_size=256000, n_positions=8192, width=3072, depth=28, heads=16,
            kv_heads=16, head_dim=256, intermediate=24576, rope_theta=1e4,
            rms_eps=1e-6),
    }

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("tie_word_embeddings", True)
        super().__init__(*args, **kwargs)

    def _attn_kwargs(self) -> dict:
        return {"scale": self.head_dim**-0.5, "logit_cap": None}

    def _mlp_act(self, g):
        """GeGLU gate: tanh-approximated GELU (HF ``gelu_pytorch_tanh``)."""
        return gelu(g, approximate=True)

    def _norm(self, h, params, name):
        """(1 + w)-scaled RMSNorm (HF ``GemmaRMSNorm``)."""
        return rms_norm(h, params[f"{name}.weight"] + 1.0, eps=self.rms_eps)

    _norm_init = "zeros"

    def _block_param_specs(self, p: str) -> list:
        w, hd = self.width, self.head_dim
        return [
            (f"{p}.self_attn.q_proj.weight", (w, self.heads * hd), "linear"),
            (f"{p}.self_attn.k_proj.weight", (w, self.kv_heads * hd), "linear"),
            (f"{p}.self_attn.v_proj.weight", (w, self.kv_heads * hd), "linear"),
            (f"{p}.self_attn.o_proj.weight", (self.heads * hd, w), "linear"),
            (f"{p}.mlp.gate_proj.weight", (w, self.intermediate), "linear"),
            (f"{p}.mlp.up_proj.weight", (w, self.intermediate), "linear"),
            (f"{p}.mlp.down_proj.weight", (self.intermediate, w), "linear"),
        ]

    def _embed(self, tap, params, ids):
        # sqrt(width) in the activation dtype (HF casts the scalar to the hidden
        # states' dtype); channel_scale's ε rule keeps relevance from scaling by it.
        normalizer = torch.tensor(self.width**0.5, dtype=self.dtype, device=self.device)
        return channel_scale(super()._embed(tap, params, ids), normalizer)


class Gemma2(Gemma):
    """Gemma 2: sandwich norms, tanh soft caps, ``query_pre_attn_scalar``, and local
    (window) attention on even layers, global on odd ones (HF ``Gemma2ForCausalLM``)."""

    _norm_names = ("input_layernorm", "post_attention_layernorm",
                   "pre_feedforward_layernorm", "post_feedforward_layernorm")
    # HF zoo: name → ctor kwargs (the checkpoints' config.json)
    _HF_VARIANTS = {
        "gemma-2-2b": dict(
            vocab_size=256000, n_positions=8192, width=2304, depth=26, heads=8,
            kv_heads=4, head_dim=256, intermediate=9216, rope_theta=1e4,
            rms_eps=1e-6, sliding_window=4096, query_pre_attn_scalar=256.0),
        "gemma-2-9b": dict(
            vocab_size=256000, n_positions=8192, width=3584, depth=42, heads=16,
            kv_heads=8, head_dim=256, intermediate=14336, rope_theta=1e4,
            rms_eps=1e-6, sliding_window=4096, query_pre_attn_scalar=256.0),
        "gemma-2-27b": dict(
            vocab_size=256000, n_positions=8192, width=4608, depth=46, heads=32,
            kv_heads=16, head_dim=128, intermediate=36864, rope_theta=1e4,
            rms_eps=1e-6, sliding_window=4096, query_pre_attn_scalar=144.0),
    }

    def __init__(self, *args, query_pre_attn_scalar: float | None = None,
                 attn_logit_softcapping: float | None = 50.0,
                 final_logit_softcapping: float | None = 30.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.query_pre_attn_scalar = (float(query_pre_attn_scalar) if query_pre_attn_scalar is not None
                                      else float(self.head_dim))
        self.attn_logit_softcapping = attn_logit_softcapping
        self.final_logit_softcapping = final_logit_softcapping

    def _attn_kwargs(self) -> dict:
        return {"scale": self.query_pre_attn_scalar**-0.5, "logit_cap": self.attn_logit_softcapping}

    def _layer_window(self, i: int) -> int | None:
        return self.sliding_window if i % 2 == 0 else None

    def _post_attention(self, tap, params, p, h, a):
        """Sandwich norm: normalise the attention output, then the residual add."""
        return residual_add(h, self._norm_tapped(tap, params, f"{p}.post_attention_layernorm", a))

    def _feed_forward(self, tap, params, p, h):
        n2 = self._norm_tapped(tap, params, f"{p}.pre_feedforward_layernorm", h)
        m = self._norm_tapped(tap, params, f"{p}.post_feedforward_layernorm", self._mlp(tap, params, p, n2))
        return residual_add(h, m)

    def _cap_logits(self, logits):
        if self.final_logit_softcapping is None:
            return logits
        cap = self.final_logit_softcapping
        return (torch.tanh(logits.float() / cap) * cap).to(logits.dtype)
