"""Kimi Linear: Kimi Delta Attention in a 3 : 1 hybrid with NoPE latent attention, and sigmoid-routed experts.

Kimi Linear (arXiv:2510.26692; HF ``moonshotai/Kimi-Linear-48B-A3B-Instruct``,
``modeling_kimi.py``) on :class:`~semanticlens_tpu_torch.models.deepseek.DeepseekV2`
(pre-norm blocks, RMSNorm, the MoE layer, MLA) and Llama's hooks. Layer i is
MLA where i + 1 is in ``full_attn_layers`` (1-based, as the config's
``linear_attn_config`` lists them), else KDA:

- **KDA** (Kimi Delta Attention, in the form of fla-org's
  ``fla/layers/kda.py``): on the normed input x, h heads of d,
  ``q = SiLU(conv_q(W_q x))``, ``k = SiLU(conv_k(W_k x))``,
  ``v = SiLU(conv_v(W_v x))``, each conv causal, depthwise, of width
  ``conv_size``, without bias, zero-padded at the sequence's start; q and k
  L2-normed per head (ε 1e-6, fla's ``l2norm``), q times d^-½; the decay
  per head and key channel in log space, in float32,
  ``g = −exp(A_log[head]) · softplus(W_fb W_fa x + dt_bias)``; the write
  strength ``β = sigmoid(W_b x)``, one a head; the gated delta rule
  (:mod:`~semanticlens_tpu_torch.ops.kda`, a hand-written kernel on the
  card) gives o; then ``RMSNorm_d(o) · w_norm ⊙ sigmoid(W_gb W_ga x + b_g)``
  per head (fla's ``FusedRMSNormGated``, ε ``rms_norm_eps``) and
  ``o_proj``.
- **MLA** with NoPE (``mla_use_nope``): DeepSeek-V2's latent attention,
  the rope channels unrotated, scale (nope + rope)^-½, no YaRN.
- **Feed-forward**: the first ``first_k_dense`` layers a SwiGLU MLP; the
  others MoE with Kimi's router (:func:`~semanticlens_tpu_torch.ops.moe.route`,
  ``scoring="sigmoid"``): float32 sigmoid scores, the top-k chosen on the
  scores plus ``mlp.gate.e_score_correction_bias``, the chosen scores
  renormalised then scaled by ``routed_scaling_factor``; the routed experts
  and ``n_shared_experts`` shared ones as in DeepSeek-V2. ``held_experts``
  names the experts this device holds (a range; all by default): the layer
  routes over all of them and adds the held experts' part only.

Names follow HF (``model.layers.0.self_attn.q_conv1d``,
``model.layers.1.mlp.gate.e_score_correction_bias``, ``model.layers.3.
self_attn.kv_b_proj`` …); the experts stack as in DeepSeek-V2's loader.
Taps, named after the module whose output they are: in KDA layers
``self_attn.{q_proj, k_proj, v_proj}`` (before the convolutions),
``self_attn.{q_conv1d, k_conv1d, v_conv1d}`` (after their SiLU),
``self_attn.o_norm`` ((B, T, h·d), the gated, normed channels: the layer's
own neurons), ``self_attn.o_proj`` and ``self_attn``; MLA, MoE and Llama
taps as in DeepSeek-V2 (``mlp.gate``: the (B, T, E) sigmoid scores;
``mlp.experts.act_fn`` over the held experts).

Spans (``utils/profiling``): ``kda.attention`` per KDA layer and, inside it,
``kda.recurrence`` (the kernel alone); ``mla.attention`` and the ``moe.*``
spans as in DeepSeek-V2. Counters ``kda.token_heads`` (B·T·h a KDA layer
call, known on the host) and ``kda.kernel`` (the recurrence kernel's
launches). Nothing in a layer reads the card back.

Out of scope, refused with an error rather than answered wrongly: LRP
through a KDA or MoE layer, interventions on their taps, and edge-padded
token rows (``pad_id``: the convolutions and the state would read the pads).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from semanticlens_tpu_torch.models.deepseek import DeepseekV2
from semanticlens_tpu_torch.models.layers import linear, rms_norm, silu
from semanticlens_tpu_torch.ops import kda, moe
from semanticlens_tpu_torch.utils.profiling import count, span

L2_EPS = 1e-6  # fla's l2norm, applied to q and k inside its KDA kernels


def l2_normalize(x: torch.Tensor, eps: float = L2_EPS) -> torch.Tensor:
    """``x · rsqrt(Σ x² + eps)`` over the last axis, in float32."""
    xf = x.float()
    return xf * torch.rsqrt(xf.square().sum(dim=-1, keepdim=True) + eps)


class KimiLinear(DeepseekV2):
    """Kimi Linear causal LM (KDA + NoPE MLA, sigmoid-routed MoE), HF names, (B, T) integer tokens.

    Parameters beyond :class:`DeepseekV2`'s: ``kda_heads`` and
    ``kda_head_dim`` (h and d of the KDA layers), ``full_attn_layers`` (the
    1-based MLA layers), ``conv_size`` (the short convolutions' width).
    ``mla_use_nope`` defaults True and ``norm_topk_prob`` (the config's
    ``moe_renormalize``) True; ``held_experts`` as in DeepSeek-V2.
    """

    _HF_VARIANTS = {
        "kimi-linear-48b-a3b": dict(
            vocab_size=163840, n_positions=1048576, width=2304, depth=27, heads=32, intermediate=9216,
            moe_intermediate=1024, n_routed_experts=256, n_shared_experts=1, experts_per_token=8, first_k_dense=1,
            moe_layer_freq=1, kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
            rope_theta=1e4, rope_scaling=None, rms_eps=1e-5, norm_topk_prob=True, routed_scaling_factor=2.446,
            kda_heads=32, kda_head_dim=128, conv_size=4, full_attn_layers=(4, 8, 12, 16, 20, 24, 27)),
    }

    def __init__(self, vocab_size: int, n_positions: int, width: int, depth: int, heads: int,
                 intermediate: int | None = None, *, kda_heads: int, kda_head_dim: int, full_attn_layers,
                 conv_size: int = 4, mla_use_nope: bool = True, norm_topk_prob: bool = True,
                 pad_id: int | None = None, **kwargs):
        if pad_id is not None:
            raise NotImplementedError("edge-padded rows (pad_id) are not built: the short convolutions and the KDA "
                                      "state would read the pads")
        self.kda_heads, self.kda_head_dim, self.conv_size = kda_heads, kda_head_dim, conv_size
        self.full_attn_layers = tuple(sorted(full_attn_layers))
        super().__init__(vocab_size, n_positions, width, depth, heads, intermediate, mla_use_nope=mla_use_nope,
                         norm_topk_prob=norm_topk_prob, **kwargs)

    @classmethod
    def from_name(cls, name: str, *, held_experts: range | None = None, dtype=torch.bfloat16, device=None):
        """The published model (``kimi-linear-48b-a3b``), holding ``held_experts`` (all by default)."""
        if name not in cls._HF_VARIANTS:
            raise ValueError(f"name must be one of {sorted(cls._HF_VARIANTS)}, got {name!r}")
        return cls(**cls._HF_VARIANTS[name], held_experts=held_experts, dtype=dtype, device=device)

    def is_mla(self, i: int) -> bool:
        """Whether layer ``i`` (0-based) is a latent-attention layer; the others are KDA."""
        return i + 1 in self.full_attn_layers

    # ------------------------------------------------------------ names, weights
    def _attn_module_names(self, p: str) -> list[str]:
        if self.is_mla(self._index(p)):
            return super()._attn_module_names(p)
        a = f"{p}.self_attn"
        return [a] + [f"{a}.{n}" for n in ("q_proj", "k_proj", "v_proj", "q_conv1d", "k_conv1d", "v_conv1d",
                                             "o_norm", "o_proj")]

    def _attn_param_specs(self, p: str) -> list:
        if self.is_mla(self._index(p)):
            return super()._attn_param_specs(p)
        w, h, d = self.width, self.kda_heads, self.kda_head_dim
        a = f"{p}.self_attn"
        return [(f"{a}.{n}_proj.weight", (w, h * d), "linear") for n in "qkv"] + [
            (f"{a}.{n}_conv1d.weight", (h * d, 1, self.conv_size), "linear") for n in "qkv"] + [
            (f"{a}.f_a_proj.weight", (w, d), "linear"),
            (f"{a}.f_b_proj.weight", (d, h * d), "linear"),
            (f"{a}.A_log", (h,), "zeros"),
            (f"{a}.dt_bias", (h * d,), "zeros"),
            (f"{a}.b_proj.weight", (w, h), "linear"),
            (f"{a}.g_a_proj.weight", (w, d), "linear"),
            (f"{a}.g_b_proj.weight", (d, h * d), "linear"),
            (f"{a}.g_b_proj.bias", (h * d,), "zeros"),
            (f"{a}.o_norm.weight", (d,), "ones"),
            (f"{a}.o_proj.weight", (h * d, w), "linear"),
        ]

    def _mlp_param_specs(self, p: str) -> list:
        specs = super()._mlp_param_specs(p)
        if self.is_moe(self._index(p)):
            specs.append((f"{p}.mlp.gate.e_score_correction_bias", (self.n_routed_experts,), "zeros"))
        return specs

    # ------------------------------------------------------------ block hooks
    def _attention(self, tap, params, p, n1, mask, cos, sin):
        if self.is_mla(self._index(p)):
            return super()._attention(tap, params, p, n1, mask, cos, sin)
        return self._kda(tap, params, p, n1)

    def _kda(self, tap, params, p, x):
        """One KDA layer on its normed input (B, T, H) → (B, T, H)."""
        a = f"{p}.self_attn"
        self._refuse_unsupported(a, "Kimi Delta Attention")
        b, t, _ = x.shape
        h, d = self.kda_heads, self.kda_head_dim
        with span("kda.attention", x.device):
            q, k, v = (self._short_conv(tap, params, a, n, x) for n in "qkv")
            f = linear(linear(x, params[f"{a}.f_a_proj.weight"]), params[f"{a}.f_b_proj.weight"]).float()
            g = -params[f"{a}.A_log"].float().exp()[:, None] * F.softplus(
                (f + params[f"{a}.dt_bias"].float()).view(b, t, h, d))
            beta = torch.sigmoid(linear(x, params[f"{a}.b_proj.weight"]).float())
            q = (l2_normalize(q.view(b, t, h, d)) * d**-0.5).to(x.dtype)
            k = l2_normalize(k.view(b, t, h, d)).to(x.dtype)
            count("kda.token_heads", b * t * h)
            with span("kda.recurrence", x.device):
                o = kda.recurrence(q, k, v.view(b, t, h, d), g, beta)
            gate = linear(linear(x, params[f"{a}.g_a_proj.weight"]), params[f"{a}.g_b_proj.weight"],
                          params[f"{a}.g_b_proj.bias"])
            o = tap(f"{a}.o_norm", self._gated_norm(o, params[f"{a}.o_norm.weight"], gate.view(b, t, h, d))
                    .reshape(b, t, h * d))
            return tap(a, tap(f"{a}.o_proj", linear(o, params[f"{a}.o_proj.weight"])))

    def _short_conv(self, tap, params, a, which, x):
        """``SiLU(conv(W x))``: the projection, then a causal depthwise convolution over T, zero-padded at the
        start, without bias (fla's ``ShortConvolution``); (B, T, H) → (B, T, h·d), both tapped."""
        y = tap(f"{a}.{which}_proj", linear(x, params[f"{a}.{which}_proj.weight"]))
        w = params[f"{a}.{which}_conv1d.weight"].to(y.dtype)
        conv = F.conv1d(y.transpose(1, 2), w, padding=w.shape[-1] - 1, groups=w.shape[0])[..., : y.shape[1]]
        return tap(f"{a}.{which}_conv1d", silu(conv.transpose(1, 2).contiguous()))

    def _gated_norm(self, o, weight, gate):
        """``RMSNorm_d(o) · weight ⊙ sigmoid(gate)`` per head, in float32, back to ``o``'s dtype."""
        return (rms_norm(o.float(), weight, eps=self.rms_eps) * torch.sigmoid(gate.float())).to(o.dtype)

    def _route(self, params, m, x2):
        """Kimi's router: sigmoid scores, the top-k on the scores plus the correction bias, the chosen scores
        renormalised, then scaled."""
        return moe.route(x2, params[f"{m}.gate.weight"], self.experts_per_token, norm_topk_prob=self.norm_topk_prob,
                         scaling_factor=self.routed_scaling_factor, scoring="sigmoid",
                         correction_bias=params[f"{m}.gate.e_score_correction_bias"])

    def __repr__(self):
        return (f"{type(self).__name__}(vocab_size={self.vocab_size}, width={self.width}, depth={self.depth}, "
                f"mla_layers={self.full_attn_layers}, kda_heads={self.kda_heads}, kda_head_dim={self.kda_head_dim}, "
                f"n_routed_experts={self.n_routed_experts}, held_experts={self.held_experts}, "
                f"experts_per_token={self.experts_per_token})")
