"""DeepSeek-V2 causal LM: multi-head latent attention with decoupled YaRN RoPE, and a mixture of experts.

DeepSeek-V2 (arXiv:2405.04434), as HF ``modeling_deepseek.py`` writes it,
on :class:`~semanticlens_tpu_torch.models.llama.Llama`'s hooks (pre-norm
blocks, RMSNorm, the causal mask, the head):

- **Attention** (MLA, without the query's low-rank path, as in
  DeepSeek-V2-Lite): ``q_proj`` gives each head [q_nope | q_pe];
  ``kv_a_proj_with_mqa`` gives the latent c and one k_pe shared by all
  heads; ``kv_b_proj(RMSNorm(c))`` gives each head [k_nope | v]. RoPE turns
  q_pe and k_pe only, after HF's de-interleave of their channels
  (``view(…, d/2, 2).transpose(-1, -2)``) and with ``rotate_half``. Causal
  softmax attention with the query/key head size nope + rope and the value
  head size ``v_head_dim`` (the SDPA wrapper takes them unequal), scale
  ``(nope + rope)^-0.5 · m²`` with YaRN's ``m = 0.1 · mscale_all_dim ·
  ln(factor) + 1``; then ``o_proj``.
- **YaRN** (``rope_scaling`` of type ``yarn``): the inverse frequencies
  blend ``1/(factor · θ^(2j/d))`` and ``1/θ^(2j/d)`` through HF's linear
  ramp between ``yarn_find_correction_range``'s bounds; the tables are
  scaled by ``mscale(mscale) / mscale(mscale_all_dim)``.
- **Feed-forward**: the first ``first_k_dense`` layers are a SwiGLU MLP of
  width ``intermediate``; the others are MoE (:mod:`~semanticlens_tpu_torch.
  ops.moe`): a float32 softmax router over ``n_routed_experts``, the greedy
  top-``experts_per_token``, the routed experts' SwiGLUs as grouped GEMMs,
  their weighted sum, plus ``n_shared_experts`` shared experts as one
  SwiGLU of width ``n_shared_experts · moe_intermediate``.

Names follow HF (``model.layers.3.self_attn.kv_b_proj``,
``model.layers.3.mlp.experts.5.up_proj`` …): :meth:`load_torch_state_dict`
takes an HF state dict and stacks each MoE layer's experts into
``mlp.experts.gate_up_proj.weight`` (E, 2·I, H) and
``mlp.experts.down_proj.weight`` (E, H, I); :meth:`hf_state_dict` unstacks
them. Taps, named after the module whose output they are: the Llama ones
where they still mean something (norms, projections, ``self_attn.heads``,
the dense MLP's), and in MoE layers ``mlp.gate`` (the (B, T, E) router
scores), ``mlp.experts.act_fn`` ((B, T, E·I), expert-major: ``silu(gate_e
x)`` of each routed (token, expert) pair, 0 elsewhere, since an expert not
routed a token computes nothing for it), ``mlp.experts`` (the weighted
routed sum), ``mlp.shared_experts.*`` and ``mlp``.

Spans (``utils/profiling``): ``mla.attention`` per layer; per MoE layer
``moe.route`` (router, top-k, sort, the pairs' gather), ``moe.experts``
(the grouped GEMMs), ``moe.combine`` (the weighted sum and the shared
experts; inside it ``moe.weighted_sum``, the routed experts' sum alone) and
``moe.tap`` (the tap's scatter, when asked for). Counters
``moe.routed_pairs`` (B·T·k per MoE layer, known on the host) and
``moe.combine.kernel`` (the combine kernel's launches, on the card); tally
``moe.expert_load.<layer>`` (the layer's tokens per expert, left on the
device). Nothing in the layer reads the card back.

Out of scope, refused with an error rather than answered wrongly: LRP
through an MoE layer, and interventions on its taps.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch

from semanticlens_tpu_torch.models.base import has_intervention
from semanticlens_tpu_torch.models.layers import (
    _lrp_active,
    attn_out_projection,
    gate_scale,
    linear,
    residual_add,
    scaled_dot_product_attention,
    silu,
)
from semanticlens_tpu_torch.models.llama import Llama
from semanticlens_tpu_torch.ops import moe
from semanticlens_tpu_torch.utils.profiling import count, span, tally


def yarn_find_correction_dim(num_rotations: float, dim: int, base: float, max_positions: int) -> float:
    """HF ``yarn_find_correction_dim``: the channel index whose wavelength makes ``num_rotations`` turns
    over ``max_positions``."""
    return (dim * math.log(max_positions / (num_rotations * 2 * math.pi))) / (2 * math.log(base))


def yarn_find_correction_range(low_rot: float, high_rot: float, dim: int, base: float, max_positions: int):
    """HF ``yarn_find_correction_range``: the ramp's (low, high) channel bounds, clipped to [0, dim − 1]."""
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base, max_positions))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base, max_positions))
    return max(low, 0), min(high, dim - 1)


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    """HF ``yarn_get_mscale``: 0.1 · mscale · ln(scale) + 1 above scale 1, else 1."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(dim: int, base: float, rope_scaling: Mapping, device=None) -> torch.Tensor:
    """YaRN's (dim/2,) float32 inverse frequencies (HF ``DeepseekV2YarnRotaryEmbedding``)."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base**exponent)
    freq_inter = 1.0 / (float(rope_scaling["factor"]) * base**exponent)
    low, high = yarn_find_correction_range(rope_scaling.get("beta_fast", 32), rope_scaling.get("beta_slow", 1),
                                           dim, base, rope_scaling["original_max_position_embeddings"])
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low) / (high - low)).clamp(0, 1)
    extra = 1.0 - ramp  # HF's inv_freq_mask: 1 keeps the unscaled frequency
    return freq_inter * (1 - extra) + freq_extra * extra


class DeepseekV2(Llama):
    """DeepSeek-V2 causal LM (MLA + MoE), HF names, (B, T) integer tokens.

    Parameters beyond :class:`Llama`'s: ``moe_intermediate`` (an expert's
    width), ``n_routed_experts``, ``n_shared_experts``,
    ``experts_per_token`` (top-k), ``first_k_dense`` (leading dense
    layers), ``moe_layer_freq``, ``kv_lora_rank``, ``qk_nope_head_dim``,
    ``qk_rope_head_dim``, ``v_head_dim``, ``norm_topk_prob`` and
    ``routed_scaling_factor``; ``rope_scaling`` is YaRN's dict (or None for
    plain RoPE over the rope channels). ``q_lora_rank`` must be None (the
    query's low-rank path of the larger DeepSeek-V2 is not built).
    """

    _YARN = {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096, "beta_fast": 32,
             "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}
    # HF zoo: name → ctor kwargs (the checkpoint's config.json)
    _HF_VARIANTS = {
        "deepseek-v2-lite": dict(
            vocab_size=102400, n_positions=163840, width=2048, depth=27, heads=16, intermediate=10944,
            moe_intermediate=1408, n_routed_experts=64, n_shared_experts=2, experts_per_token=6,
            first_k_dense=1, moe_layer_freq=1, kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
            v_head_dim=128, rope_theta=1e4, rope_scaling=_YARN, rms_eps=1e-6, norm_topk_prob=False,
            routed_scaling_factor=1.0),
    }

    def __init__(self, vocab_size: int, n_positions: int, width: int, depth: int, heads: int,
                 intermediate: int | None = None, *, moe_intermediate: int, n_routed_experts: int,
                 n_shared_experts: int, experts_per_token: int, kv_lora_rank: int, qk_nope_head_dim: int,
                 qk_rope_head_dim: int, v_head_dim: int, first_k_dense: int = 1, moe_layer_freq: int = 1,
                 q_lora_rank: int | None = None, norm_topk_prob: bool = False, routed_scaling_factor: float = 1.0,
                 rope_theta: float = 10000.0, rope_scaling: Mapping | None = None, rms_eps: float = 1e-6,
                 tie_word_embeddings: bool = False, dtype=torch.bfloat16, pad_id: int | None = None, device=None):
        if q_lora_rank is not None:
            raise NotImplementedError("the query's low-rank path (q_lora_rank) is not built")
        if experts_per_token > n_routed_experts:
            raise ValueError(f"experts_per_token={experts_per_token} exceeds n_routed_experts={n_routed_experts}")
        self.moe_intermediate = moe_intermediate
        self.n_routed_experts = n_routed_experts
        self.n_shared_experts = n_shared_experts
        self.experts_per_token = experts_per_token
        self.first_k_dense = first_k_dense
        self.moe_layer_freq = moe_layer_freq
        self.kv_lora_rank = kv_lora_rank
        self.qk_nope_head_dim = qk_nope_head_dim
        self.qk_rope_head_dim = qk_rope_head_dim
        self.v_head_dim = v_head_dim
        self.norm_topk_prob = norm_topk_prob
        self.routed_scaling_factor = float(routed_scaling_factor)
        super().__init__(vocab_size, n_positions, width, depth, heads, heads, intermediate,
                         head_dim=qk_nope_head_dim + qk_rope_head_dim, rope_theta=rope_theta,
                         rope_scaling=rope_scaling, rms_eps=rms_eps, tie_word_embeddings=tie_word_embeddings,
                         dtype=dtype, pad_id=pad_id, device=device)
        self.softmax_scale = self.head_dim**-0.5
        if self.rope_scaling and self.rope_scaling.get("mscale_all_dim"):
            m = yarn_get_mscale(float(self.rope_scaling["factor"]), float(self.rope_scaling["mscale_all_dim"]))
            self.softmax_scale *= m * m

    def is_moe(self, i: int) -> bool:
        """Whether layer ``i`` is an MoE layer (HF: past the leading dense ones, every ``moe_layer_freq``-th)."""
        return self.n_routed_experts > 0 and i >= self.first_k_dense and i % self.moe_layer_freq == 0

    @staticmethod
    def _index(p: str) -> int:
        return int(p.rsplit(".", 1)[1])

    # ------------------------------------------------------------ names, weights
    def _block_module_names(self, p: str) -> list[str]:
        a = f"{p}.self_attn"
        names = [a, f"{a}.q_proj", f"{a}.kv_a_proj_with_mqa", f"{a}.kv_a_layernorm", f"{a}.kv_b_proj",
                 f"{a}.heads", f"{a}.o_proj", f"{p}.mlp"]
        if not self.is_moe(self._index(p)):
            return names + [f"{p}.mlp.{n}" for n in ("gate_proj", "up_proj", "act_fn", "down_proj")]
        s = f"{p}.mlp.shared_experts"
        return names + [f"{p}.mlp.gate", f"{p}.mlp.experts", f"{p}.mlp.experts.act_fn", s] + [
            f"{s}.{n}" for n in ("gate_proj", "up_proj", "act_fn", "down_proj")]

    def _block_param_specs(self, p: str) -> list:
        """(name, shape, kind): linears in the JAX layout (in, out), the stacked experts in the port's."""
        w, h = self.width, self.heads
        a = f"{p}.self_attn"
        specs = [
            (f"{a}.q_proj.weight", (w, h * self.head_dim), "linear"),
            (f"{a}.kv_a_proj_with_mqa.weight", (w, self.kv_lora_rank + self.qk_rope_head_dim), "linear"),
            (f"{a}.kv_a_layernorm.weight", (self.kv_lora_rank,), self._norm_init),
            (f"{a}.kv_b_proj.weight", (self.kv_lora_rank, h * (self.qk_nope_head_dim + self.v_head_dim)), "linear"),
            (f"{a}.o_proj.weight", (h * self.v_head_dim, w), "linear"),
        ]
        if not self.is_moe(self._index(p)):
            return specs + _swiglu_specs(f"{p}.mlp", w, self.intermediate)
        e, i = self.n_routed_experts, self.moe_intermediate
        return specs + [
            (f"{p}.mlp.gate.weight", (w, e), "linear"),
            (f"{p}.mlp.experts.gate_up_proj.weight", (e, 2 * i, w), "linear"),
            (f"{p}.mlp.experts.down_proj.weight", (e, w, i), "linear"),
        ] + _swiglu_specs(f"{p}.mlp.shared_experts", w, i * self.n_shared_experts)

    def load_torch_state_dict(self, state_dict: Mapping, *, partial: bool = False) -> dict[str, torch.Tensor]:
        """An HF ``DeepseekV2ForCausalLM``-named state dict, each MoE layer's experts stacked, placed.

        ``partial=True`` places the tensors of the layers present and checks
        nothing is missing within them (a layer-by-layer load).
        """
        sd = dict(state_dict)
        for i in range(self.depth):
            prefix = f"model.layers.{i}.mlp.experts"
            if not self.is_moe(i) or f"{prefix}.0.gate_proj.weight" not in sd:
                continue
            gate_up, down = [], []
            for e in range(self.n_routed_experts):
                gate_up.append(torch.cat([torch.as_tensor(sd.pop(f"{prefix}.{e}.gate_proj.weight")),
                                          torch.as_tensor(sd.pop(f"{prefix}.{e}.up_proj.weight"))]))
                down.append(torch.as_tensor(sd.pop(f"{prefix}.{e}.down_proj.weight")))
            sd[f"{prefix}.gate_up_proj.weight"] = torch.stack(gate_up)
            sd[f"{prefix}.down_proj.weight"] = torch.stack(down)
            del gate_up, down
        return self._place(sd, partial=partial)

    def hf_state_dict(self, params: Mapping) -> dict[str, torch.Tensor]:
        """The port's parameters under HF's names: each MoE layer's experts unstacked (views)."""
        out = {}
        inter = self.moe_intermediate
        for name, t in params.items():
            if name.endswith(".mlp.experts.gate_up_proj.weight"):
                prefix = name[: -len("gate_up_proj.weight")]
                for e in range(t.shape[0]):
                    out[f"{prefix}{e}.gate_proj.weight"] = t[e, :inter]
                    out[f"{prefix}{e}.up_proj.weight"] = t[e, inter:]
            elif name.endswith(".mlp.experts.down_proj.weight"):
                prefix = name[: -len("down_proj.weight")]
                for e in range(t.shape[0]):
                    out[f"{prefix}{e}.down_proj.weight"] = t[e]
            else:
                out[name] = t
        return out

    # ------------------------------------------------------------------ rope
    def _rope_tables(self, t: int):
        """cos/sin (T, rope dim), float32, HF half-rotation layout, over the decoupled rope channels only."""
        d = self.qk_rope_head_dim
        if self.rope_scaling is not None:
            inv_freq = yarn_inv_freq(d, self.rope_theta, self.rope_scaling, self.device)
            factor = float(self.rope_scaling["factor"])
            scale = (yarn_get_mscale(factor, float(self.rope_scaling.get("mscale", 1)))
                     / yarn_get_mscale(factor, float(self.rope_scaling.get("mscale_all_dim", 0))))
        else:
            inv_freq = 1.0 / (self.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=self.device) / d))
            scale = 1.0
        ang = torch.arange(t, dtype=torch.float32, device=self.device)[:, None] * inv_freq[None, :]
        emb = torch.cat([ang, ang], dim=-1)
        return torch.cos(emb) * scale, torch.sin(emb) * scale

    def _rotate(self, x, cos, sin):
        """(B, T, n, d) rope channels: HF's de-interleave, then ``x·cos + rotate_half(x)·sin`` in float32."""
        b, t, n, d = x.shape
        xf = x.float().reshape(b, t, n, d // 2, 2).transpose(-1, -2).reshape(b, t, n, d)
        rot = torch.cat([-xf[..., d // 2 :], xf[..., : d // 2]], dim=-1)
        if cos.ndim == 2:
            cos, sin = cos[None], sin[None]
        return (xf * cos[:, :, None, :] + rot * sin[:, :, None, :]).to(x.dtype)

    # ------------------------------------------------------------ block hooks
    def _attention(self, tap, params, p, n1, mask, cos, sin):
        a = f"{p}.self_attn"
        h, dn, dr, dv = self.heads, self.qk_nope_head_dim, self.qk_rope_head_dim, self.v_head_dim
        b, t, _ = n1.shape
        with span("mla.attention", n1.device):
            q = tap(f"{a}.q_proj", linear(n1, params[f"{a}.q_proj.weight"])).view(b, t, h, dn + dr)
            ckv = tap(f"{a}.kv_a_proj_with_mqa", linear(n1, params[f"{a}.kv_a_proj_with_mqa.weight"]))
            c, k_pe = ckv.split([self.kv_lora_rank, dr], dim=-1)
            c = self._norm_tapped(tap, params, f"{a}.kv_a_layernorm", c)
            kv = tap(f"{a}.kv_b_proj", linear(c, params[f"{a}.kv_b_proj.weight"])).view(b, t, h, dn + dv)
            k_nope, v = kv.split([dn, dv], dim=-1)
            q_nope, q_pe = q.split([dn, dr], dim=-1)
            q = torch.cat([q_nope, self._rotate(q_pe, cos, sin)], dim=-1)
            k_pe = self._rotate(k_pe.reshape(b, t, 1, dr), cos, sin).expand(b, t, h, dr)
            k = torch.cat([k_nope, k_pe], dim=-1)
            out = scaled_dot_product_attention(q.reshape(b, t, -1), k.reshape(b, t, -1), v.reshape(b, t, -1), h,
                                               mask=mask, scale=self.softmax_scale)
            out = attn_out_projection(tap, f"{a}.heads", f"{a}.o_proj", out, params[f"{a}.o_proj.weight"], None, h)
            return tap(a, out)

    def _feed_forward(self, tap, params, p, h):
        i = self._index(p)
        if not self.is_moe(i):
            return super()._feed_forward(tap, params, p, h)
        n2 = self._norm_tapped(tap, params, f"{p}.post_attention_layernorm", h)
        return residual_add(h, self._moe(tap, params, p, n2, i))

    def _moe(self, tap, params, p, x, i):
        """One MoE layer on its normed input (B, T, H) → (B, T, H)."""
        m = f"{p}.mlp"
        self._refuse_unsupported(m)
        b, t, w = x.shape
        n, e, k, dev = b * t, self.n_routed_experts, self.experts_per_token, x.device
        x2 = x.reshape(n, w)
        with span("moe.route", dev):
            scores, weights, experts = moe.route(x2, params[f"{m}.gate.weight"], k, norm_topk_prob=self.norm_topk_prob,
                                                 scaling_factor=self.routed_scaling_factor)
            d = moe.dispatch(experts, e)
            x_sorted = x2.index_select(0, d.token)
        count("moe.routed_pairs", n * k)
        tally(f"moe.expert_load.{i}", d.counts)
        tap(f"{m}.gate", scores.view(b, t, e))
        with span("moe.experts", dev):
            act, y_sorted = moe.expert_ffn(x_sorted, params[f"{m}.experts.gate_up_proj.weight"],
                                           params[f"{m}.experts.down_proj.weight"], d)
        if f"{m}.experts.act_fn" in tap.requested:
            with span("moe.tap", dev):
                tap(f"{m}.experts.act_fn", moe.scatter_tap(act, d, n, e).view(b, t, -1))
        with span("moe.combine", dev):
            with span("moe.weighted_sum", dev):
                summed = moe.combine(y_sorted, weights, d, n)
            routed = tap(f"{m}.experts", summed.view(b, t, w))
            return tap(m, routed + self._swiglu(tap, params, f"{m}.shared_experts", x))

    def _swiglu(self, tap, params, prefix, x):
        g = tap(f"{prefix}.gate_proj", linear(x, params[f"{prefix}.gate_proj.weight"]))
        u = tap(f"{prefix}.up_proj", linear(x, params[f"{prefix}.up_proj.weight"]))
        act = tap(f"{prefix}.act_fn", silu(g))
        return tap(f"{prefix}.down_proj", linear(gate_scale(u, act), params[f"{prefix}.down_proj.weight"]))

    def _refuse_unsupported(self, m: str) -> None:
        """LRP and interventions through an MoE layer are not built: raise rather than answer wrongly."""
        if _lrp_active():
            raise NotImplementedError(f"{m}: LRP through a mixture-of-experts layer is not supported")
        live = [n for n in self._block_module_names(m.rsplit(".", 1)[0]) if n.startswith(m) and has_intervention(n)]
        if live:
            raise NotImplementedError(f"interventions on mixture-of-experts taps are not supported: {live}")

    def __repr__(self):
        return (f"{type(self).__name__}(vocab_size={self.vocab_size}, width={self.width}, depth={self.depth}, "
                f"heads={self.heads}, kv_lora_rank={self.kv_lora_rank}, n_routed_experts={self.n_routed_experts}, "
                f"experts_per_token={self.experts_per_token}, n_shared_experts={self.n_shared_experts}, "
                f"moe_intermediate={self.moe_intermediate}, intermediate={self.intermediate})")


def _swiglu_specs(prefix: str, width: int, inter: int) -> list:
    return [(f"{prefix}.gate_proj.weight", (width, inter), "linear"),
            (f"{prefix}.up_proj.weight", (width, inter), "linear"),
            (f"{prefix}.down_proj.weight", (inter, width), "linear")]
