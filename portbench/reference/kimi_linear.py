"""Plain float32 Kimi Linear (arXiv:2510.26692) for the benchmark, drawn and run layer by layer.

The equations and names of the test tree's plain reference
(``tests/plain/kimi_linear.py``: HF ``modeling_kimi.py`` and fla-org's
``fla/layers/kda.py`` in float32, configuration keys of HF's
``config.json``), with what a card-sized run needs:

- the weights' draws (:func:`layer_specs`, :func:`outer_specs`): layer i
  from its own stream (seed, ``LAYER_STREAM + i``), the embedding, the
  final norm and the head from (seed, ``OUTER_STREAM``), streams no other
  input of the cell uses; of the routed experts only the held ones
  (``held_experts``, this device's share), each apart, under HF's names;
  the router keeps all ``num_experts_published`` outputs;
- :func:`token_means`: the model over a block of sequences one layer at a
  time (each layer drawn, run over the whole block, freed), stopping after
  the deepest tapped layer, with the token mean of each tap computed where
  it arises. The KDA recurrence runs over the whole block at once, token by
  token (fla's ``naive_recurrent_kda``); the projections around it, the
  MLA (its logits explicit) and the dense MLPs run ``PIECE`` or
  ``ATTN_CHUNK`` sequences at a time, so that 2,048-token sequences fit;
- ``quant="int8"``: every linear layer through ``ops.linear``'s int8
  rounding (the router's too), the control.

Departures from HF, none of which changes a value in float32: every tensor
is float32; the short convolutions are written out as a sum over their
taps; q and k are L2-normed (ε 1e-6) and q scaled by d^-½ before the
recurrence, as fla's kernels do inside; the router's top-k is sorted (the
same set; one expert group makes HF's grouped top-k the plain one); the
MoE is a loop over the held experts, each run on the tokens its routing
mask gives it, and the absent experts add nothing (the configuration's
deployment); positions 0 … T−1, no padding, no cache; causal MLA by a −inf
mask on explicit logits. TF32 stays off under ``ops.strict_float32``,
where the check runs it.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import ops, weights

LAYER_STREAM = 1 << 24  # layer i draws from LAYER_STREAM + i
OUTER_STREAM = LAYER_STREAM - 1
ATTN_CHUNK = 2  # sequences per chunk of explicit MLA logits: 2 × 32 heads × 2,048² float32 = 1.07 GB
PIECE = 16  # sequences per piece of a layer's projections and MLPs
DT_BIAS_MEAN = -4.6  # dt_bias = −4.6 + N(0, 1): softplus of about 0.01, HF's initial range
L2_EPS = 1e-6


def held(cfg: dict) -> range:
    return range(*cfg["held_experts"])


def is_mla(cfg: dict, i: int) -> bool:
    return i + 1 in cfg["linear_attn_config"]["full_attn_layers"]


def is_moe(cfg: dict, i: int) -> bool:
    return i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0


def _swiglu_specs(prefix: str, w: int, inter: int) -> list:
    return [(f"{prefix}.gate_proj.weight", (inter, w), ("normal", w**-0.5)),
            (f"{prefix}.up_proj.weight", (inter, w), ("normal", w**-0.5)),
            (f"{prefix}.down_proj.weight", (w, inter), ("normal", inter**-0.5))]


def _kda_specs(cfg: dict, a: str) -> list:
    w, lin = cfg["hidden_size"], cfg["linear_attn_config"]
    h, d, kw = lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]
    return [(f"{a}.{n}_proj.weight", (h * d, w), ("normal", w**-0.5)) for n in "qkv"] + [
        (f"{a}.{n}_conv1d.weight", (h * d, kw), ("normal", kw**-0.5)) for n in "qkv"] + [  # (C, 1, K) after the draw
        (f"{a}.f_a_proj.weight", (d, w), ("normal", w**-0.5)),
        (f"{a}.f_b_proj.weight", (h * d, d), ("normal", d**-0.5)),
        (f"{a}.A_log", (h,), ("scale", 0.5)),
        (f"{a}.dt_bias", (h * d,), ("normal", 1.0)),  # shifted by DT_BIAS_MEAN after the draw
        (f"{a}.b_proj.weight", (h, w), ("normal", w**-0.5)),
        (f"{a}.g_a_proj.weight", (d, w), ("normal", w**-0.5)),
        (f"{a}.g_b_proj.weight", (h * d, d), ("normal", d**-0.5)),
        (f"{a}.g_b_proj.bias", (h * d,), ("normal", 0.5)),
        (f"{a}.o_norm.weight", (d,), ("scale", 0.1)),
        (f"{a}.o_proj.weight", (w, h * d), ("normal", (h * d) ** -0.5)),
    ]


def _mla_specs(cfg: dict, a: str) -> list:
    w, h, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return [
        (f"{a}.q_proj.weight", (h * (dn + dr), w), ("normal", w**-0.5)),
        (f"{a}.kv_a_proj_with_mqa.weight", (r + dr, w), ("normal", w**-0.5)),
        (f"{a}.kv_a_layernorm.weight", (r,), ("scale", 0.1)),
        (f"{a}.kv_b_proj.weight", (h * (dn + dv), r), ("normal", r**-0.5)),
        (f"{a}.o_proj.weight", (w, h * dv), ("normal", (h * dv) ** -0.5)),
    ]


def layer_specs(cfg: dict, i: int) -> list:
    """(HF name, torch shape, draw) of layer ``i``, the held experts only."""
    w, p = cfg["hidden_size"], f"model.layers.{i}"
    specs = [(f"{p}.input_layernorm.weight", (w,), ("scale", 0.1)),
             (f"{p}.post_attention_layernorm.weight", (w,), ("scale", 0.1))]
    specs += (_mla_specs if is_mla(cfg, i) else _kda_specs)(cfg, f"{p}.self_attn")
    if not is_moe(cfg, i):
        return specs + _swiglu_specs(f"{p}.mlp", w, cfg["intermediate_size"])
    inter, e = cfg["moe_intermediate_size"], cfg["num_experts_published"]
    specs += [(f"{p}.mlp.gate.weight", (e, w), ("normal", w**-0.5)),
              (f"{p}.mlp.gate.e_score_correction_bias", (e,), ("normal", 0.02))]
    for j in held(cfg):
        specs += _swiglu_specs(f"{p}.mlp.experts.{j}", w, inter)
    return specs + _swiglu_specs(f"{p}.mlp.shared_experts", w, inter * cfg["num_shared_experts"])


def outer_specs(cfg: dict) -> list:
    """The token embedding N(0, 1), the final norm and the untied head."""
    w, v = cfg["hidden_size"], cfg["vocab_size"]
    return [("model.embed_tokens.weight", (v, w), ("normal", 1.0)), ("model.norm.weight", (w,), ("scale", 0.1)),
            ("lm_head.weight", (v, w), ("normal", w**-0.5))]


def draw_layer(cfg: dict, i: int, seed: int, device, dtype) -> dict[str, torch.Tensor]:
    """Layer ``i``'s weights in ``dtype`` (the served type), as the program is given them, HF's shapes."""
    out = weights.draw(layer_specs(cfg, i), seed, LAYER_STREAM + i, device, dtype)
    if not is_mla(cfg, i):
        a = f"model.layers.{i}.self_attn"
        out[f"{a}.dt_bias"] += DT_BIAS_MEAN
        for n in "qkv":
            out[f"{a}.{n}_conv1d.weight"] = out[f"{a}.{n}_conv1d.weight"].unsqueeze(1)
    return out


def draw_outer(cfg: dict, seed: int, device, dtype) -> dict[str, torch.Tensor]:
    return weights.draw(outer_specs(cfg), seed, OUTER_STREAM, device, dtype)


def rms_norm(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def silu(x):
    return x * torch.sigmoid(x)


def l2norm(x):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def short_conv(x, weight):
    """Causal depthwise convolution over T of (B, T, C) with an HF (C, 1, K) kernel, zero-padded at the start."""
    kw, t = weight.shape[-1], x.shape[1]
    padded = torch.nn.functional.pad(x, (0, 0, kw - 1, 0))
    return sum(padded[:, i : i + t] * weight[:, 0, i] for i in range(kw))


def recurrence(q, k, v, g, beta):
    """(B, T, h, d) q, k, v, log decays g, (B, T, h) beta → o: the gated delta rule token by token, in place on one
    (B·h, d, d) state."""
    b, t, h, d = q.shape
    s = torch.zeros(b * h, d, v.shape[-1], device=q.device)
    o = torch.empty_like(v)
    for i in range(t):
        s.mul_(g[:, i].exp().reshape(b * h, d, 1))
        ki = k[:, i].reshape(b * h, 1, d)
        u = torch.bmm(ki, s)  # (B·h, 1, d): Sᵀ k
        delta = beta[:, i].reshape(b * h, 1, 1) * (v[:, i].reshape(b * h, 1, -1) - u)
        s.baddbmm_(ki.transpose(1, 2), delta)
        o[:, i] = torch.bmm(q[:, i].reshape(b * h, 1, d), s).view(b, h, -1)
    return o


def _pieces(b: int, n: int):
    return (slice(s, s + n) for s in range(0, b, n))


def kda(p: dict, a: str, x, cfg, quant, means: dict, taps):
    """One KDA layer on its normed input (B, T, H); fills ``means`` with the tapped token means."""
    b, t, w = x.shape
    lin = cfg["linear_attn_config"]
    h, d = lin["num_heads"], lin["head_dim"]
    q, k, v, g = (torch.empty(b, t, h, d, device=x.device) for _ in range(4))
    beta = torch.empty(b, t, h, device=x.device)
    for sl in _pieces(b, PIECE):
        xs = x[sl]
        q[sl], k[sl], v[sl] = (silu(short_conv(ops.linear(xs, p[f"{a}.{n}_proj.weight"], quant=quant),
                                               p[f"{a}.{n}_conv1d.weight"])).view(-1, t, h, d) for n in "qkv")
        f = ops.linear(ops.linear(xs, p[f"{a}.f_a_proj.weight"], quant=quant), p[f"{a}.f_b_proj.weight"], quant=quant)
        g[sl] = -p[f"{a}.A_log"].exp()[:, None] * torch.nn.functional.softplus(
            (f + p[f"{a}.dt_bias"]).view(-1, t, h, d))
        beta[sl] = torch.sigmoid(ops.linear(xs, p[f"{a}.b_proj.weight"], quant=quant))
    q, k = l2norm(q) * d**-0.5, l2norm(k)
    o = recurrence(q, k, v, g, beta)
    del q, k, v, g, beta
    out, tapped = torch.empty_like(x), []
    for sl in _pieces(b, PIECE):
        xs = x[sl]
        gate = ops.linear(ops.linear(xs, p[f"{a}.g_a_proj.weight"], quant=quant), p[f"{a}.g_b_proj.weight"],
                          p[f"{a}.g_b_proj.bias"], quant=quant)
        on = (rms_norm(o[sl], p[f"{a}.o_norm.weight"], cfg["rms_norm_eps"])
              * torch.sigmoid(gate.view(-1, t, h, d))).reshape(-1, t, h * d)
        if f"{a}.o_norm" in taps:
            tapped.append(on.mean(dim=1))
        out[sl] = ops.linear(on, p[f"{a}.o_proj.weight"], quant=quant)
    if tapped:
        means[f"{a}.o_norm"] = torch.cat(tapped)
    return out


def mla(p: dict, a: str, x, cfg, quant):
    """Latent attention without rotation (``mla_use_nope``), ``ATTN_CHUNK`` sequences at a time."""
    b, t, _ = x.shape
    h, dn, dr, dv = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    causal = torch.triu(torch.ones(t, t, dtype=torch.bool, device=x.device), diagonal=1)
    out = torch.empty_like(x)
    for sl in _pieces(b, ATTN_CHUNK):
        xs = x[sl]
        n = xs.shape[0]
        q = ops.linear(xs, p[f"{a}.q_proj.weight"], quant=quant).view(n, t, h, dn + dr).transpose(1, 2)
        c, k_pe = ops.linear(xs, p[f"{a}.kv_a_proj_with_mqa.weight"], quant=quant).split([cfg["kv_lora_rank"], dr], -1)
        c = rms_norm(c, p[f"{a}.kv_a_layernorm.weight"], cfg["rms_norm_eps"])
        kv = ops.linear(c, p[f"{a}.kv_b_proj.weight"], quant=quant).view(n, t, h, dn + dv).transpose(1, 2)
        k_nope, v = kv.split([dn, dv], dim=-1)
        key = torch.cat([k_nope, k_pe.reshape(n, 1, t, dr).expand(n, h, t, dr)], dim=-1)
        logits = (q @ key.transpose(2, 3)) * (dn + dr) ** -0.5
        probs = torch.softmax(logits.masked_fill(causal, -math.inf), dim=-1)
        del logits
        out[sl] = ops.linear((probs @ v).transpose(1, 2).reshape(n, t, h * dv), p[f"{a}.o_proj.weight"], quant=quant)
    return out


def mlp(p: dict, prefix: str, x, quant, means: dict, taps):
    """A SwiGLU MLP, ``PIECE`` sequences at a time."""
    out, tapped = torch.empty_like(x), []
    for sl in _pieces(x.shape[0], PIECE):
        act = silu(ops.linear(x[sl], p[f"{prefix}.gate_proj.weight"], quant=quant))
        if f"{prefix}.act_fn" in taps:
            tapped.append(act.mean(dim=1))
        out[sl] = ops.linear(act * ops.linear(x[sl], p[f"{prefix}.up_proj.weight"], quant=quant),
                             p[f"{prefix}.down_proj.weight"], quant=quant)
    if tapped:
        means[f"{prefix}.act_fn"] = torch.cat(tapped)
    return out


def moe(p: dict, m: str, x, cfg, quant, means: dict, taps):
    """One MoE layer on its normed input (B, T, H): the held experts' part and the shared expert."""
    b, t, w = x.shape
    k, inter, kept = cfg["num_experts_per_token"], cfg["moe_intermediate_size"], held(cfg)
    x2 = x.reshape(b * t, w)
    scores = torch.sigmoid(ops.linear(x2, p[f"{m}.gate.weight"], quant=quant))
    top_i = torch.topk(scores + p[f"{m}.gate.e_score_correction_bias"], k, dim=-1)[1]  # the bias chooses only
    top_w = scores.gather(1, top_i)
    if k > 1 and cfg["moe_renormalize"]:
        top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
    top_w = top_w * cfg["routed_scaling_factor"]
    if f"{m}.gate" in taps:
        means[f"{m}.gate"] = scores.view(b, t, -1).mean(dim=1)
    tap = f"{m}.experts.act_fn" in taps
    acts = torch.zeros(b, len(kept), inter, device=x.device) if tap else None
    y = torch.zeros_like(x2)
    for j, e in enumerate(kept):
        routed = top_i == e  # the routing mask
        rows = routed.any(dim=-1).nonzero().squeeze(1)
        if rows.numel() == 0:
            continue
        xe, pre = x2[rows], f"{m}.experts.{e}"
        act = silu(ops.linear(xe, p[f"{pre}.gate_proj.weight"], quant=quant))
        ye = ops.linear(act * ops.linear(xe, p[f"{pre}.up_proj.weight"], quant=quant), p[f"{pre}.down_proj.weight"],
                        quant=quant)
        y.index_add_(0, rows, (top_w * routed).sum(dim=-1)[rows, None] * ye)
        if tap:
            acts[:, j] = torch.zeros(b, inter, device=x.device).index_add_(0, rows // t, act)
    if tap:
        means[f"{m}.experts.act_fn"] = acts.view(b, -1) / t
    return y.view(b, t, w) + mlp(p, f"{m}.shared_experts", x, quant, means, taps)


def token_means(cfg: dict, seed: int, device, tokens: torch.Tensor, taps, served, quant=None) -> dict:
    """(B, T) tokens → ``{tap: (B, C)}`` token means of the tapped activations, layer by layer.

    Each layer's weights are drawn in the served type ``served`` (as the
    program was given them), widened to float32, used over the whole block
    and freed before the next is drawn.
    """
    taps = tuple(taps)
    last = max(int(name.split(".")[2]) for name in taps)
    eps = cfg["rms_norm_eps"]
    outer = draw_outer(cfg, seed, device, served)
    x = outer["model.embed_tokens.weight"].float()[tokens.long()]
    del outer
    means: dict = {}
    for i in range(last + 1):
        p = weights.as_float32(draw_layer(cfg, i, seed, device, served))
        pre = f"model.layers.{i}"
        n1 = rms_norm(x, p[f"{pre}.input_layernorm.weight"], eps)
        a = f"{pre}.self_attn"
        x = x + (mla(p, a, n1, cfg, quant) if is_mla(cfg, i) else kda(p, a, n1, cfg, quant, means, taps))
        del n1
        n2 = rms_norm(x, p[f"{pre}.post_attention_layernorm.weight"], eps)
        if is_moe(cfg, i):
            x = x + moe(p, f"{pre}.mlp", n2, cfg, quant, means, taps)
        else:
            x = x + mlp(p, f"{pre}.mlp", n2, quant, means, taps)
        if pre in taps:
            means[pre] = x.mean(dim=1)
        del p, n2
    missing = set(taps) - set(means)
    if missing:
        raise KeyError(f"the reference computes no tap {sorted(missing)}")
    return means
