"""Plain float32 DeepSeek-V2 forward (arXiv:2405.04434), from HF ``modeling_deepseek.py``'s equations.

It imports nothing of the port and no JAX: the tests hold
``semanticlens_tpu_torch.models.DeepseekV2`` against it. Configuration keys
are HF ``config.json``'s (``hidden_size``, ``kv_lora_rank``,
``rope_scaling`` …); weights are an HF-named state dict, each expert's
projections apart (``model.layers.3.mlp.experts.5.up_proj.weight``).
:func:`forward` turns TF32 off (``torch.backends.cuda.matmul.allow_tf32 =
torch.backends.cudnn.allow_tf32 = False``), so a float32 matmul stays
float32 on a card too.

Departures from HF, none of which changes a value in float32:

- Every tensor is float32, so HF's casts (RMSNorm's to the input dtype,
  the router's to float32, the combine's to the weights' dtype) are
  no-ops; the RoPE tables are not rounded to the activations' dtype.
- The router's top-k is ``torch.topk(sorted=True)`` (HF: ``sorted=False``):
  the same set, in another order, and the sum over it is the same.
- No sort, no grouped GEMM, no tap scatter: the MoE is a dense loop over
  the experts, each run on the tokens a routing mask gives it (HF's
  training form ``y[flat_topk_idx == i] = expert(x[flat_topk_idx == i])``).
  The experts' tap ``mlp.experts.act_fn`` is (B, T, E·I), expert-major,
  holding ``silu(gate_e x)`` where token and expert are paired, else 0.
- Positions are 0 … T−1 (no padding); no KV cache; causal attention by
  an explicit −inf mask on the logits before the softmax.
"""

from __future__ import annotations

import math

import torch


def rms_norm(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def silu(x):
    return x * torch.sigmoid(x)


def yarn_find_correction_dim(num_rotations, dim, base, max_positions):
    return (dim * math.log(max_positions / (num_rotations * 2 * math.pi))) / (2 * math.log(base))


def yarn_find_correction_range(low_rot, high_rot, dim, base, max_positions):
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base, max_positions))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base, max_positions))
    return max(low, 0), min(high, dim - 1)


def yarn_get_mscale(scale=1.0, mscale=1.0):
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def inv_freq(cfg: dict) -> torch.Tensor:
    """The rope channels' inverse frequencies: YaRN's blend where ``rope_scaling`` says so, else plain."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    rs = cfg.get("rope_scaling")
    if not rs:
        return extra
    inter = 1.0 / (float(rs["factor"]) * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    low, high = yarn_find_correction_range(rs["beta_fast"], rs["beta_slow"], dim, base,
                                           rs["original_max_position_embeddings"])
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def rope_tables(cfg: dict, t: int):
    rs = cfg.get("rope_scaling")
    scale = 1.0
    if rs:
        scale = yarn_get_mscale(rs["factor"], rs["mscale"]) / yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
    freqs = torch.outer(torch.arange(t, dtype=torch.float32), inv_freq(cfg))
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos() * scale, emb.sin() * scale


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x, cos, sin):
    """(B, H, T, d): HF's de-interleave of the channels, then the half rotation."""
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return x * cos + rotate_half(x) * sin


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def attention(sd, p, x, cfg, cos, sin, out, taps):
    b, t, _ = x.shape
    h, dn, dr, dv = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    a = f"{p}.self_attn"
    q = (x @ sd[f"{a}.q_proj.weight"].t()).view(b, t, h, dn + dr).transpose(1, 2)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    ckv = x @ sd[f"{a}.kv_a_proj_with_mqa.weight"].t()
    c, k_pe = ckv.split([cfg["kv_lora_rank"], dr], dim=-1)
    k_pe = k_pe.reshape(b, t, 1, dr).transpose(1, 2)
    c = rms_norm(c, sd[f"{a}.kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    kv = (c @ sd[f"{a}.kv_b_proj.weight"].t()).view(b, t, h, dn + dv).transpose(1, 2)
    k_nope, v = kv.split([dn, dv], dim=-1)
    q_pe, k_pe = apply_rope(q_pe, cos, sin), apply_rope(k_pe, cos, sin)
    query = torch.cat([q_nope, q_pe], dim=-1)
    key = torch.cat([k_nope, k_pe.expand(b, h, t, dr)], dim=-1)
    logits = (query @ key.transpose(2, 3)) * softmax_scale(cfg)
    causal = torch.triu(torch.ones(t, t, dtype=torch.bool), diagonal=1)
    probs = torch.softmax(logits.masked_fill(causal, -math.inf), dim=-1)
    o = (probs @ v).transpose(1, 2).reshape(b, t, h * dv)
    y = o @ sd[f"{a}.o_proj.weight"].t()
    if f"{a}.heads" in taps:
        w_o = sd[f"{a}.o_proj.weight"].view(-1, h, dv)
        out[f"{a}.heads"] = torch.linalg.vector_norm(torch.einsum("bthc,ohc->btho", o.view(b, t, h, dv), w_o), dim=-1)
    out[a] = y
    return y


def mlp(sd, prefix, x, out):
    act = silu(x @ sd[f"{prefix}.gate_proj.weight"].t())
    out[f"{prefix}.act_fn"] = act
    y = (act * (x @ sd[f"{prefix}.up_proj.weight"].t())) @ sd[f"{prefix}.down_proj.weight"].t()
    out[prefix] = y
    return y


def moe(sd, p, x, cfg, out, chosen, i):
    b, t, w = x.shape
    m = f"{p}.mlp"
    e_count, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    x2 = x.reshape(b * t, w)
    scores = torch.softmax(x2 @ sd[f"{m}.gate.weight"].t(), dim=-1)
    top_w, top_i = torch.topk(scores, k, dim=-1)
    if k > 1 and cfg["norm_topk_prob"]:
        top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        top_w = top_w * cfg["routed_scaling_factor"]
    out[f"{m}.gate"] = scores.view(b, t, e_count)
    chosen[i] = top_i.view(b, t, k)
    inter = cfg["moe_intermediate_size"]
    y = torch.zeros_like(x2)
    act_tap = torch.zeros(b * t, e_count, inter)
    for e in range(e_count):
        routed = top_i == e  # (N, k): the routing mask
        rows = routed.any(dim=-1)
        xe = x2[rows]
        pre = f"{m}.experts.{e}"
        act = silu(xe @ sd[f"{pre}.gate_proj.weight"].t())
        ye = (act * (xe @ sd[f"{pre}.up_proj.weight"].t())) @ sd[f"{pre}.down_proj.weight"].t()
        y[rows] += (top_w * routed).sum(dim=-1)[rows, None] * ye
        act_tap[rows, e] = act
    out[f"{m}.experts.act_fn"] = act_tap.view(b, t, e_count * inter)
    out[f"{m}.experts"] = y.view(b, t, w)
    res = y.view(b, t, w) + mlp(sd, f"{m}.shared_experts", x, out)
    out[m] = res
    return res


def is_moe(cfg: dict, i: int) -> bool:
    return (cfg["n_routed_experts"] is not None and i >= cfg["first_k_dense_replace"]
            and i % cfg["moe_layer_freq"] == 0)


def forward(sd: dict, tokens: torch.Tensor, cfg: dict, taps=()):
    """(B, T) tokens → (logits (B, T, V), {tap: activation}, {MoE layer: (B, T, k) chosen experts}).

    ``taps`` names the activations kept (module names, as the port's);
    every one computed is returned, the requested ones included.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, chosen = {}, {}
    t = tokens.shape[1]
    eps = cfg["rms_norm_eps"]
    x = sd["model.embed_tokens.weight"][tokens.long()]
    cos, sin = rope_tables(cfg, t)
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        x = x + attention(sd, p, rms_norm(x, sd[f"{p}.input_layernorm.weight"], eps), cfg, cos, sin, out, taps)
        n2 = rms_norm(x, sd[f"{p}.post_attention_layernorm.weight"], eps)
        x = x + (moe(sd, p, n2, cfg, out, chosen, i) if is_moe(cfg, i) else mlp(sd, f"{p}.mlp", n2, out))
        out[p] = x
    x = rms_norm(x, sd["model.norm.weight"], eps)
    logits = x @ sd["lm_head.weight"].t()
    return logits, out, chosen
