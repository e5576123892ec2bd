"""Plain float32 Kimi Linear forward (arXiv:2510.26692), from HF ``modeling_kimi.py`` and fla-org's
``fla/layers/kda.py``.

It imports nothing of the port and no JAX: the tests hold
``semanticlens_tpu_torch.models.KimiLinear`` against it. Configuration keys
are HF ``config.json``'s (``hidden_size``, ``num_experts``,
``linear_attn_config`` …); weights are an HF-named state dict, each expert's
projections apart (``model.layers.3.mlp.experts.5.up_proj.weight``).
:func:`forward` turns TF32 off (``torch.backends.cuda.matmul.allow_tf32 =
torch.backends.cudnn.allow_tf32 = False``), so a float32 matmul stays
float32 on a card too. ``held`` is the range of routed experts a device
holds: the router keeps all ``num_experts`` outputs, and only the held
experts' part of the routed sum is added (an expert-parallel share).

Layer i (0-based) is MLA where i + 1 is in ``linear_attn_config
["full_attn_layers"]``, else KDA. Departures from HF, none of which changes
a value in float32:

- Every tensor is float32, so HF's casts are no-ops.
- KDA is a loop over the tokens (fla's ``naive_recurrent_kda``), not the
  chunked kernel; q and k are L2-normed (ε 1e-6, fla's ``l2norm``) and q
  scaled by d^-½ before it, as fla's kernels do inside. The short
  convolutions are written out as a sum over their taps.
- MLA with ``mla_use_nope``: no rotation, scale (nope + rope)^-½. Causal
  attention by an explicit −inf mask on the logits before the softmax.
- The router's top-k is ``torch.topk(sorted=True)``: the same set. The MoE
  is a dense loop over the held experts, each run on the tokens its routing
  mask gives it. ``num_expert_group`` 1 makes HF's grouped top-k the plain
  one.
- Positions 0 … T−1, no padding, no cache.

Readings the config does not fix, taken here as in the benchmark's
configuration file (``assumed``): ``A_log`` of shape (h,), ``dt_bias`` of
(h·d,), ``g_b_proj`` with a bias, the convolutions without one.
"""

from __future__ import annotations

import math

import torch

L2_EPS = 1e-6


def rms_norm(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def silu(x):
    return x * torch.sigmoid(x)


def softplus(x):
    return torch.where(x > 20, x, torch.log1p(torch.exp(torch.clamp(x, max=20))))


def l2norm(x):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def short_conv(x, weight):
    """Causal depthwise convolution over T of (B, T, C) with an HF (C, 1, K) kernel, zero-padded at the start."""
    kw, t = weight.shape[-1], x.shape[1]
    padded = torch.nn.functional.pad(x, (0, 0, kw - 1, 0))
    return sum(padded[:, i : i + t] * weight[:, 0, i] for i in range(kw))


def recurrence(q, k, v, g, beta):
    """(B, T, h, d) q, k, v, log decays g, (B, T, h) beta → o (B, T, h, d): the gated delta rule token by token."""
    b, t, h, d = q.shape
    s = torch.zeros(b, h, d, v.shape[-1])
    o = torch.zeros_like(v)
    for i in range(t):
        s = s * g[:, i].exp()[..., None]
        u = (k[:, i, :, :, None] * s).sum(-2)
        s = s + torch.einsum("bhk,bhv->bhkv", beta[:, i, :, None] * k[:, i], v[:, i] - u)
        o[:, i] = torch.einsum("bhk,bhkv->bhv", q[:, i], s)
    return o


def kda(sd, a, x, cfg, out):
    b, t, _ = x.shape
    lin = cfg["linear_attn_config"]
    h, d = lin["num_heads"], lin["head_dim"]

    def proj(n):
        y = x @ sd[f"{a}.{n}_proj.weight"].t()
        out[f"{a}.{n}_proj"] = y
        c = silu(short_conv(y, sd[f"{a}.{n}_conv1d.weight"]))
        out[f"{a}.{n}_conv1d"] = c
        return c.view(b, t, h, d)

    q, k, v = proj("q"), proj("k"), proj("v")
    q, k = l2norm(q) * d**-0.5, l2norm(k)
    f = (x @ sd[f"{a}.f_a_proj.weight"].t()) @ sd[f"{a}.f_b_proj.weight"].t() + sd[f"{a}.dt_bias"]
    g = -sd[f"{a}.A_log"].exp()[:, None] * softplus(f.view(b, t, h, d))
    beta = torch.sigmoid(x @ sd[f"{a}.b_proj.weight"].t())
    o = recurrence(q, k, v, g, beta)
    gate = (x @ sd[f"{a}.g_a_proj.weight"].t()) @ sd[f"{a}.g_b_proj.weight"].t() + sd[f"{a}.g_b_proj.bias"]
    o = rms_norm(o, sd[f"{a}.o_norm.weight"], cfg["rms_norm_eps"]) * torch.sigmoid(gate.view(b, t, h, d))
    out[f"{a}.o_norm"] = o.reshape(b, t, h * d)
    y = o.reshape(b, t, h * d) @ sd[f"{a}.o_proj.weight"].t()
    out[f"{a}.o_proj"] = out[a] = y
    return y


def mla(sd, a, x, cfg, out):
    b, t, _ = x.shape
    h, dn, dr, dv = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = (x @ sd[f"{a}.q_proj.weight"].t()).view(b, t, h, dn + dr).transpose(1, 2)
    c, k_pe = (x @ sd[f"{a}.kv_a_proj_with_mqa.weight"].t()).split([cfg["kv_lora_rank"], dr], dim=-1)
    c = rms_norm(c, sd[f"{a}.kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    kv = (c @ sd[f"{a}.kv_b_proj.weight"].t()).view(b, t, h, dn + dv).transpose(1, 2)
    k_nope, v = kv.split([dn, dv], dim=-1)
    key = torch.cat([k_nope, k_pe.reshape(b, 1, t, dr).expand(b, h, t, dr)], dim=-1)  # NoPE: no rotation
    logits = (q @ key.transpose(2, 3)) * (dn + dr) ** -0.5
    causal = torch.triu(torch.ones(t, t, dtype=torch.bool), diagonal=1)
    probs = torch.softmax(logits.masked_fill(causal, -math.inf), dim=-1)
    y = (probs @ v).transpose(1, 2).reshape(b, t, h * dv) @ sd[f"{a}.o_proj.weight"].t()
    out[a] = y
    return y


def mlp(sd, prefix, x, out):
    act = silu(x @ sd[f"{prefix}.gate_proj.weight"].t())
    out[f"{prefix}.act_fn"] = act
    y = (act * (x @ sd[f"{prefix}.up_proj.weight"].t())) @ sd[f"{prefix}.down_proj.weight"].t()
    out[prefix] = y
    return y


def route(sd, m, x2, cfg):
    """HF ``KimiMoEGate``: (scores (N, E), weights (N, k), experts (N, k))."""
    k = cfg["num_experts_per_token"]
    scores = torch.sigmoid(x2 @ sd[f"{m}.gate.weight"].t())
    experts = torch.topk(scores + sd[f"{m}.gate.e_score_correction_bias"], k, dim=-1)[1]  # the bias chooses only
    weights = scores.gather(1, experts)
    if k > 1 and cfg["moe_renormalize"]:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return scores, weights * cfg["routed_scaling_factor"], experts


def routed(sd, m, x2, cfg, held, out=None):
    """The held experts' part of the routed sum (N, H); fills ``out`` with the gate and the held experts' tap."""
    n, w = x2.shape
    inter = cfg["moe_intermediate_size"]
    scores, weights, experts = route(sd, m, x2, cfg)
    y = torch.zeros_like(x2)
    act_tap = torch.zeros(n, len(held), inter)
    for j, e in enumerate(held):
        mask = experts == e
        rows = mask.any(dim=-1)
        pre = f"{m}.experts.{e}"
        act = silu(x2[rows] @ sd[f"{pre}.gate_proj.weight"].t())
        ye = (act * (x2[rows] @ sd[f"{pre}.up_proj.weight"].t())) @ sd[f"{pre}.down_proj.weight"].t()
        y[rows] += (weights * mask).sum(dim=-1)[rows, None] * ye
        act_tap[rows, j] = act
    if out is not None:
        out[f"{m}.gate"] = scores
        out[f"{m}.experts.act_fn"] = act_tap.view(n, -1)
        out[f"{m}.experts"] = y
    return y, experts


def moe(sd, p, x, cfg, held, out, chosen, i):
    b, t, w = x.shape
    m = f"{p}.mlp"
    y, experts = routed(sd, m, x.reshape(b * t, w), cfg, held, out)
    for name in (f"{m}.gate", f"{m}.experts.act_fn", f"{m}.experts"):
        out[name] = out[name].view(b, t, -1)
    chosen[i] = experts.view(b, t, -1)
    res = y.view(b, t, w) + mlp(sd, f"{m}.shared_experts", x, out)
    out[m] = res
    return res


def is_mla(cfg: dict, i: int) -> bool:
    return i + 1 in cfg["linear_attn_config"]["full_attn_layers"]


def is_moe(cfg: dict, i: int) -> bool:
    return i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0


def forward(sd: dict, tokens: torch.Tensor, cfg: dict, held: range | None = None):
    """(B, T) tokens → (logits (B, T, V), {tap: activation}, {MoE layer: (B, T, k) chosen experts}).

    ``held``: the routed experts whose part is added (all by default).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    held = range(cfg["num_experts"]) if held is None else held
    out, chosen = {}, {}
    eps = cfg["rms_norm_eps"]
    x = sd["model.embed_tokens.weight"][tokens.long()]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        n1 = rms_norm(x, sd[f"{p}.input_layernorm.weight"], eps)
        x = x + (mla if is_mla(cfg, i) else kda)(sd, f"{p}.self_attn", n1, cfg, out)
        n2 = rms_norm(x, sd[f"{p}.post_attention_layernorm.weight"], eps)
        x = x + (moe(sd, p, n2, cfg, held, out, chosen, i) if is_moe(cfg, i) else mlp(sd, f"{p}.mlp", n2, out))
        out[p] = x
    x = rms_norm(x, sd["model.norm.weight"], eps)
    return x @ sd["lm_head.weight"].t(), out, chosen
