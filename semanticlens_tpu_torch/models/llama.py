"""Llama-style causal LM with named activation taps, and Qwen2.

Counterpart of ``semanticlens_tpu.models.llama``: RMSNorm (pre-norm, no
biases), rotary position embeddings, grouped-query attention and a SwiGLU
MLP — Llama 2/3, Mistral (``sliding_window=``), TinyLlama, and Qwen2/2.5
(q/k/v biases, :class:`Qwen2`). Module and parameter names follow Hugging
Face ``LlamaForCausalLM`` (``model.layers.3.mlp.gate_proj`` …); HF stores
``nn.Linear`` weights (out, in), the port's layout, so its state dicts load
as they are.

Float32 islands, as in the JAX package: the RoPE tables and rotation,
RMSNorm, and (Gemma 2) the soft-capped attention logits and the final
logit cap run in float32 inside a bf16 forward.

LRP: RMSNorm carries the detached-denominator rule, attention is CP-LRP,
and the SwiGLU product routes relevance through ``up_proj`` with
``silu(gate)`` a constant gate (``layers.gate_scale``). RoPE sits on the
query/key path, which receives no relevance under CP-LRP.

The block hooks (``_embed``, ``_norm``, ``_attn_kwargs``, ``_mlp_act``,
``_layer_window``, ``_qkv``, ``_post_attention``, ``_mlp``,
``_feed_forward``, ``_cap_logits``) are what Gemma, Gemma 2 and Phi-3
specialise (``models/gemma.py``, ``models/phi.py``).
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

from semanticlens_tpu_torch.models.base import TapCollector
from semanticlens_tpu_torch.models.gpt import TokenLM, additive_mask, pad_positions
from semanticlens_tpu_torch.models.layers import (
    attn_out_projection,
    gate_scale,
    linear,
    residual_add,
    rms_norm,
    scaled_dot_product_attention,
    silu,
)
from semanticlens_tpu_torch.utils.device import resolve_device


def _llama3_scaled_inv_freq(inv_freq, rope_scaling: Mapping):
    """HF ``rope_type="llama3"`` frequency rescaling (Llama 3.1/3.2), float32.

    Long wavelengths divide by ``factor``, short ones pass through, and a
    smooth ramp interpolates between the two bands.
    """
    factor = float(rope_scaling["factor"])
    low = float(rope_scaling.get("low_freq_factor", 1.0))
    high = float(rope_scaling.get("high_freq_factor", 4.0))
    orig = float(rope_scaling.get("original_max_position_embeddings", 8192))

    wavelen = 2.0 * math.pi / inv_freq
    smooth = (orig / wavelen - low) / (high - low)
    interp = (1.0 - smooth) / factor * inv_freq + smooth * inv_freq
    out = torch.where(wavelen > orig / low, inv_freq / factor, interp)
    return torch.where(wavelen < orig / high, inv_freq, out)


class Llama(TokenLM):
    """Llama-family causal LM, HF names, (B, T) integer tokens.

    Parameters
    ----------
    vocab_size, n_positions, width, depth, heads, kv_heads, intermediate :
        architecture (or :meth:`from_name`).
    head_dim : decoupled from ``width // heads`` (Gemma); derived when omitted.
    rope_theta : RoPE base (1e4 for Llama 2, 5e5 for 3.x).
    rope_scaling : optional HF ``rope_type="llama3"`` dict.
    rms_eps : RMSNorm epsilon.
    tie_word_embeddings : the head reuses ``embed_tokens`` (Llama 3.2 1B/3B).
    sliding_window : keys more than window−1 behind a query are dropped.
    attention_bias : q/k/v projection biases (Qwen2).
    dtype : activation dtype (bfloat16 by default).
    pad_id : edge-padding token id, or None (as ``GPT2.pad_id``).
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    _LLAMA3_ROPE = {
        "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
        "original_max_position_embeddings": 8192,
    }
    # HF zoo: name → ctor kwargs (the checkpoints' config.json)
    _HF_VARIANTS = {
        "llama-2-7b": dict(
            vocab_size=32000, n_positions=4096, width=4096, depth=32, heads=32,
            kv_heads=32, intermediate=11008, rope_theta=1e4, rms_eps=1e-5),
        "tinyllama-1.1b": dict(
            vocab_size=32000, n_positions=2048, width=2048, depth=22, heads=32,
            kv_heads=4, intermediate=5632, rope_theta=1e4, rms_eps=1e-5),
        "llama-3.2-1b": dict(
            vocab_size=128256, n_positions=131072, width=2048, depth=16, heads=32,
            kv_heads=8, intermediate=8192, rope_theta=5e5, rms_eps=1e-5,
            rope_scaling=_LLAMA3_ROPE, tie_word_embeddings=True),
        "llama-3.2-3b": dict(
            vocab_size=128256, n_positions=131072, width=3072, depth=28, heads=24,
            kv_heads=8, intermediate=8192, rope_theta=5e5, rms_eps=1e-5,
            rope_scaling=_LLAMA3_ROPE, tie_word_embeddings=True),
        "llama-3.1-8b": dict(
            vocab_size=128256, n_positions=131072, width=4096, depth=32, heads=32,
            kv_heads=8, intermediate=14336, rope_theta=5e5, rms_eps=1e-5,
            rope_scaling=_LLAMA3_ROPE),
        "mistral-7b-v0.1": dict(
            vocab_size=32000, n_positions=32768, width=4096, depth=32, heads=32,
            kv_heads=8, intermediate=14336, rope_theta=1e4, rms_eps=1e-5,
            sliding_window=4096),
    }

    def __init__(
        self,
        vocab_size: int,
        n_positions: int,
        width: int,
        depth: int,
        heads: int,
        kv_heads: int | None = None,
        intermediate: int | None = None,
        *,
        head_dim: int | None = None,
        rope_theta: float = 10000.0,
        rope_scaling: Mapping | None = None,
        rms_eps: float = 1e-6,
        tie_word_embeddings: bool = False,
        sliding_window: int | None = None,
        attention_bias: bool = False,
        dtype=torch.bfloat16,
        pad_id: int | None = None,
        device=None,
    ):
        self.vocab_size = vocab_size
        self.n_positions = n_positions
        self.width = width
        self.depth = depth
        self.heads = heads
        self.kv_heads = kv_heads if kv_heads is not None else heads
        if heads % self.kv_heads:
            raise ValueError(f"heads={heads} not divisible by kv_heads={self.kv_heads}")
        if head_dim is None:
            if width % heads:
                raise ValueError(f"width={width} not divisible by heads={heads}")
            head_dim = width // heads
        self.head_dim = head_dim
        self.intermediate = intermediate if intermediate is not None else 4 * width
        self.rope_theta = float(rope_theta)
        self.rope_scaling = dict(rope_scaling) if rope_scaling else None
        self.rms_eps = rms_eps
        self.tie_word_embeddings = tie_word_embeddings
        self.sliding_window = sliding_window
        self.attention_bias = attention_bias
        self.dtype = dtype
        self.pad_id = pad_id
        self.device = resolve_device(device)
        self.module_names = tuple(self._enumerate_module_names())

    @classmethod
    def from_name(cls, name: str, *, dtype=torch.bfloat16, pad_id: int | None = None, device=None):
        """An HF-zoo-sized model (``llama-2-7b`` … ``mistral-7b-v0.1``)."""
        if name not in cls._HF_VARIANTS:
            raise ValueError(f"name must be one of {sorted(cls._HF_VARIANTS)}, got {name!r}")
        return cls(**cls._HF_VARIANTS[name], dtype=dtype, pad_id=pad_id, device=device)

    # Per-layer RMSNorm names and their init kind (Gemma: sandwich norms, zero-init (1+w) scales).
    _norm_names = ("input_layernorm", "post_attention_layernorm")
    _norm_init = "ones"

    def _enumerate_module_names(self):
        names = ["model", "model.embed_tokens", "model.layers"]
        for i in range(self.depth):
            p = f"model.layers.{i}"
            names += [p] + [f"{p}.{n}" for n in self._norm_names]
            names += self._block_module_names(p)
        return names + ["model.norm", "lm_head"]

    def _block_module_names(self, p: str) -> list[str]:
        return [f"{p}.self_attn", f"{p}.self_attn.q_proj", f"{p}.self_attn.k_proj", f"{p}.self_attn.v_proj",
                f"{p}.self_attn.heads", f"{p}.self_attn.o_proj", f"{p}.mlp", f"{p}.mlp.gate_proj",
                f"{p}.mlp.up_proj", f"{p}.mlp.act_fn", f"{p}.mlp.down_proj"]

    def _param_specs(self):
        """(name, shape, kind) in the JAX package's layout (linear (in, out))."""
        w = self.width
        specs = [("model.embed_tokens.weight", (self.vocab_size, w), "embed")]
        for i in range(self.depth):
            p = f"model.layers.{i}"
            specs += [(f"{p}.{n}.weight", (w,), self._norm_init) for n in self._norm_names]
            specs += self._block_param_specs(p)
        specs.append(("model.norm.weight", (w,), self._norm_init))
        if not self.tie_word_embeddings:
            specs.append(("lm_head.weight", (w, self.vocab_size), "linear"))
        return specs

    def _block_param_specs(self, p: str) -> list:
        w, hd = self.width, self.head_dim
        specs = [
            (f"{p}.self_attn.q_proj.weight", (w, self.heads * hd), "linear"),
            (f"{p}.self_attn.k_proj.weight", (w, self.kv_heads * hd), "linear"),
            (f"{p}.self_attn.v_proj.weight", (w, self.kv_heads * hd), "linear"),
            (f"{p}.self_attn.o_proj.weight", (self.heads * hd, w), "linear"),
        ]
        if self.attention_bias:  # Qwen2's q/k/v biases (o_proj: none)
            specs += [
                (f"{p}.self_attn.q_proj.bias", (self.heads * hd,), "zeros"),
                (f"{p}.self_attn.k_proj.bias", (self.kv_heads * hd,), "zeros"),
                (f"{p}.self_attn.v_proj.bias", (self.kv_heads * hd,), "zeros"),
            ]
        return specs + [
            (f"{p}.mlp.gate_proj.weight", (w, self.intermediate), "linear"),
            (f"{p}.mlp.up_proj.weight", (w, self.intermediate), "linear"),
            (f"{p}.mlp.down_proj.weight", (self.intermediate, w), "linear"),
        ]

    def _init_std(self, kind: str) -> float:
        """HF Llama init: N(0, 0.02)."""
        return 0.02

    # ------------------------------------------------------------------ rope
    def _rope_tables(self, t: int):
        """cos/sin (T, head_dim), float32, HF half-rotation layout (angles of [0, hd/2) repeated)."""
        hd = self.head_dim
        inv_freq = 1.0 / (self.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=self.device) / hd))
        if self.rope_scaling is not None:
            inv_freq = _llama3_scaled_inv_freq(inv_freq, self.rope_scaling)
        ang = torch.arange(t, dtype=torch.float32, device=self.device)[:, None] * inv_freq[None, :]
        emb = torch.cat([ang, ang], dim=-1)
        return torch.cos(emb), torch.sin(emb)

    def _apply_rope(self, x, cos, sin):
        """Rotate (B, T, n·head_dim) channels per head in float32; tables (T, hd) or (B, T, hd)."""
        b, t, d = x.shape
        xh = x.reshape(b, t, d // self.head_dim, self.head_dim).float()
        half = self.head_dim // 2
        rot = torch.cat([-xh[..., half:], xh[..., :half]], dim=-1)
        if cos.ndim == 2:
            cos, sin = cos[None], sin[None]
        out = xh * cos[:, :, None, :] + rot * sin[:, :, None, :]
        return out.reshape(b, t, d).to(x.dtype)

    def _rope(self, ids, t: int):
        """RoPE tables; with ``pad_id`` they index real-token positions and become (B, T, hd)."""
        cos, sin = self._rope_tables(t)
        if self.pad_id is not None:
            _, pos_ids = pad_positions(ids, self.pad_id)
            cos, sin = cos[pos_ids], sin[pos_ids]
        return cos, sin

    def _window_mask(self, ids, t: int, window: int | None):
        """Additive causal mask, (T, T); a sliding ``window`` keeps 0 ≤ i−j < window; with
        ``pad_id`` edge-pad keys are dropped (each position keeps itself), (B, 1, T, T)."""
        pos = torch.arange(t, device=ids.device)
        allowed = pos[None, :] <= pos[:, None]
        if window is not None:
            allowed &= pos[:, None] - pos[None, :] < window
        return additive_mask(allowed, pad_positions(ids, self.pad_id)[0] if self.pad_id is not None else None)

    # ------------------------------------------------------------ block hooks
    def _embed(self, tap, params, ids):
        return tap("model.embed_tokens", F.embedding(ids, params["model.embed_tokens.weight"]))

    def _norm(self, h, params, name):
        return rms_norm(h, params[f"{name}.weight"], eps=self.rms_eps)

    def _norm_tapped(self, tap, params, name, h):
        return tap(name, self._norm(h, params, name))

    def _attn_kwargs(self) -> dict:
        """Extra attention kwargs (Gemma 2: scale and soft cap)."""
        return {}

    def _mlp_act(self, g):
        return silu(g)

    def _layer_window(self, i: int) -> int | None:
        return self.sliding_window

    def _qkv(self, tap, params, p, n1):
        """(q, k, v): HF module-output taps, before RoPE."""
        def proj(which):
            bias = params.get(f"{p}.self_attn.{which}.bias") if self.attention_bias else None
            return tap(f"{p}.self_attn.{which}", linear(n1, params[f"{p}.self_attn.{which}.weight"], bias))

        return proj("q_proj"), proj("k_proj"), proj("v_proj")

    def _attention(self, tap, params, p, n1, mask, cos, sin):
        q, k, v = self._qkv(tap, params, p, n1)
        q = self._apply_rope(q, cos, sin)
        k = self._apply_rope(k, cos, sin)
        a = scaled_dot_product_attention(q, k, v, self.heads, mask=mask, n_kv_heads=self.kv_heads,
                                         **self._attn_kwargs())
        a = attn_out_projection(tap, f"{p}.self_attn.heads", f"{p}.self_attn.o_proj", a,
                                params[f"{p}.self_attn.o_proj.weight"], None, self.heads)
        return tap(f"{p}.self_attn", a)

    def _post_attention(self, tap, params, p, h, a):
        """Pre-norm residual: the attention output adds straight back."""
        return residual_add(h, a)

    def _mlp(self, tap, params, p, n2):
        g = tap(f"{p}.mlp.gate_proj", linear(n2, params[f"{p}.mlp.gate_proj.weight"]))
        u = tap(f"{p}.mlp.up_proj", linear(n2, params[f"{p}.mlp.up_proj.weight"]))
        act = tap(f"{p}.mlp.act_fn", self._mlp_act(g))
        m = gate_scale(u, act)  # LRP: the gate is a constant, relevance rides up_proj
        m = tap(f"{p}.mlp.down_proj", linear(m, params[f"{p}.mlp.down_proj.weight"]))
        return tap(f"{p}.mlp", m)

    def _feed_forward(self, tap, params, p, h):
        n2 = self._norm_tapped(tap, params, f"{p}.post_attention_layernorm", h)
        return residual_add(h, self._mlp(tap, params, p, n2))

    def _cap_logits(self, logits):
        return logits

    # ----------------------------------------------------------------- apply
    def apply(self, params: Mapping, x, tap_names: Sequence[str] = ()):
        """(B, T) int tokens → (logits (B, T, V), taps). Token taps (B, T, C)."""
        tap = TapCollector(tap_names)
        ids = self._ids(x)
        t = ids.shape[1]
        h = self._embed(tap, params, ids)
        cos, sin = self._rope(ids, t)
        masks = {win: self._window_mask(ids, t, win) for win in {self._layer_window(i) for i in range(self.depth)}}
        for i in range(self.depth):
            p = f"model.layers.{i}"
            n1 = self._norm_tapped(tap, params, f"{p}.input_layernorm", h)
            a = self._attention(tap, params, p, n1, masks[self._layer_window(i)], cos, sin)
            h = self._post_attention(tap, params, p, h, a)
            h = self._feed_forward(tap, params, p, h)
            h = tap(p, h)
        h = tap("model.layers", h)
        h = self._norm_tapped(tap, params, "model.norm", h)
        h = tap("model", h)
        head_w = params["model.embed_tokens.weight" if self.tie_word_embeddings else "lm_head.weight"]
        logits = tap("lm_head", linear(h, head_w))
        return self._cap_logits(logits), tap.taps

    # ------------------------------------------------------------------ load
    def load_torch_state_dict(self, state_dict: Mapping) -> dict[str, torch.Tensor]:
        """An HF ``LlamaForCausalLM``-named state dict (the port's layout), placed.

        ``model.rotary_emb.inv_freq`` (a derived buffer) and, with tied
        embeddings, ``lm_head.weight`` are ignored.
        """
        return self._place(state_dict)

    def __repr__(self):
        return (f"{type(self).__name__}(vocab_size={self.vocab_size}, n_positions={self.n_positions}, "
                f"width={self.width}, depth={self.depth}, heads={self.heads}, kv_heads={self.kv_heads}, "
                f"intermediate={self.intermediate}, tied={self.tie_word_embeddings})")


class Qwen2(Llama):
    """Qwen2/2.5 causal LM: the Llama recipe plus q/k/v projection biases
    (HF ``Qwen2ForCausalLM``; ``attention_bias`` defaults True)."""

    # HF zoo: name → ctor kwargs (the checkpoints' config.json)
    _HF_VARIANTS = {
        "qwen2.5-0.5b": dict(
            vocab_size=151936, n_positions=32768, width=896, depth=24, heads=14,
            kv_heads=2, intermediate=4864, rope_theta=1e6, rms_eps=1e-6,
            tie_word_embeddings=True),
        "qwen2.5-1.5b": dict(
            vocab_size=151936, n_positions=32768, width=1536, depth=28, heads=12,
            kv_heads=2, intermediate=8960, rope_theta=1e6, rms_eps=1e-6,
            tie_word_embeddings=True),
        "qwen2.5-7b": dict(
            vocab_size=152064, n_positions=32768, width=3584, depth=28, heads=28,
            kv_heads=4, intermediate=18944, rope_theta=1e6, rms_eps=1e-6),
    }

    def __init__(self, *args, attention_bias: bool = True, **kwargs):
        super().__init__(*args, attention_bias=attention_bias, **kwargs)
