"""Phi-3 causal LM with named activation taps.

Counterpart of ``semanticlens_tpu.models.phi``: the Llama decoder with
fused projections — one ``qkv_proj`` emitting q‖k‖v and one
``gate_up_proj`` emitting gate‖up — and a sliding window (2047 on the 4k
checkpoints). Names follow HF ``Phi3ForCausalLM``. Taps:
``…self_attn.qkv_proj`` is the fused (B, T, (H+2·KV)·hd) output,
``…mlp.gate_up_proj`` the fused (B, T, 2·I) one, ``…mlp.activation_fn`` the
gated SiLU channels (B, T, I). Under LRP each fused projection is one
rule-bearing linear, as in the JAX package, so the composite's rule order
is the same. The long-context "longrope" checkpoints are not implemented.
"""

from __future__ import annotations

from semanticlens_tpu_torch.models.layers import gate_scale, linear, silu
from semanticlens_tpu_torch.models.llama import Llama


class Phi3(Llama):
    """Phi-3 causal LM, HF ``Phi3ForCausalLM`` names, (B, T) integer tokens."""

    # HF zoo: name → ctor kwargs (the checkpoints' config.json)
    _HF_VARIANTS = {
        "phi-3-mini-4k": dict(
            vocab_size=32064, n_positions=4096, width=3072, depth=32, heads=32,
            kv_heads=32, intermediate=8192, rope_theta=1e4, rms_eps=1e-5,
            sliding_window=2047),
        "phi-3-medium-4k": dict(
            vocab_size=32064, n_positions=4096, width=5120, depth=40, heads=40,
            kv_heads=10, intermediate=17920, rope_theta=1e4, rms_eps=1e-5,
            sliding_window=2047),
    }

    def _block_module_names(self, p: str) -> list[str]:
        return [f"{p}.self_attn", f"{p}.self_attn.qkv_proj", f"{p}.self_attn.heads", f"{p}.self_attn.o_proj",
                f"{p}.mlp", f"{p}.mlp.gate_up_proj", f"{p}.mlp.activation_fn", f"{p}.mlp.down_proj"]

    def _block_param_specs(self, p: str) -> list:
        w, hd = self.width, self.head_dim
        fused = (self.heads + 2 * self.kv_heads) * hd
        return [
            (f"{p}.self_attn.qkv_proj.weight", (w, fused), "linear"),
            (f"{p}.self_attn.o_proj.weight", (self.heads * hd, w), "linear"),
            (f"{p}.mlp.gate_up_proj.weight", (w, 2 * self.intermediate), "linear"),
            (f"{p}.mlp.down_proj.weight", (self.intermediate, w), "linear"),
        ]

    def _qkv(self, tap, params, p, n1):
        """Fused projection, split q‖k‖v (HF ``Phi3Attention``)."""
        qkv = tap(f"{p}.self_attn.qkv_proj", linear(n1, params[f"{p}.self_attn.qkv_proj.weight"]))
        qd, kd = self.heads * self.head_dim, self.kv_heads * self.head_dim
        return qkv[..., :qd], qkv[..., qd : qd + kd], qkv[..., qd + kd :]

    def _mlp(self, tap, params, p, n2):
        """Fused gate‖up with the SiLU gate on the first half (HF ``Phi3MLP``)."""
        gu = tap(f"{p}.mlp.gate_up_proj", linear(n2, params[f"{p}.mlp.gate_up_proj.weight"]))
        g, u = gu[..., : self.intermediate], gu[..., self.intermediate :]
        act = tap(f"{p}.mlp.activation_fn", silu(g))
        m = gate_scale(u, act)  # LRP: the gate is a constant (models/llama.py)
        m = tap(f"{p}.mlp.down_proj", linear(m, params[f"{p}.mlp.down_proj.weight"]))
        return tap(f"{p}.mlp", m)
