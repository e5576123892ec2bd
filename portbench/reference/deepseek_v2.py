"""Plain float32 DeepSeek-V2 (arXiv:2405.04434) for the benchmark, drawn and run layer by layer.

The equations and names of the test tree's plain reference
(``tests/plain/deepseek_v2.py``: HF ``modeling_deepseek.py`` in float32,
configuration keys of HF's ``config.json``), with what a card-sized run
needs:

- the weights' draws (:func:`layer_specs`, :func:`outer_specs`): layer i
  from its own stream (seed, ``LAYER_STREAM + i``), the embedding, the
  final norm and the head from (seed, ``OUTER_STREAM``), streams no other
  input of the benchmark uses; each expert apart, under HF's names;
- :func:`token_means`: the model over a block of sequences one layer at a
  time (each layer drawn, run over the whole block, freed), stopping after
  the deepest tapped layer, with the token mean of each tap computed where
  it arises. The experts' tap is never laid out whole: per expert, the
  routed tokens' ``silu(gate_e x)`` are summed per sequence (the tap is 0
  elsewhere, so the sum over all tokens is the sum over routed ones);
- ``quant="int8"``: every linear layer through ``ops.linear``'s int8
  rounding (the router's too), the control.

Departures from HF, none of which changes a value in float32: every tensor
is float32 (HF's casts are no-ops; the RoPE tables are not rounded); the
router's top-k is sorted (the same set); the MoE is a loop over the experts,
each run on the tokens its routing mask gives it (HF's training form), with
no sort, grouped GEMM or tap scatter; positions 0 … T−1, no padding, no KV
cache; causal attention by a −inf mask on explicit logits, in chunks of
sequences. TF32 stays off under ``ops.strict_float32``, where the check
runs it.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import ops, weights

LAYER_STREAM = 1 << 24  # layer i draws from LAYER_STREAM + i
OUTER_STREAM = LAYER_STREAM - 1
ATTN_CHUNK = 32  # sequences per chunk of explicit attention logits


def is_moe(cfg: dict, i: int) -> bool:
    return bool(cfg["n_routed_experts"]) and i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0


def _swiglu_specs(prefix: str, w: int, inter: int) -> list:
    return [(f"{prefix}.gate_proj.weight", (inter, w), ("normal", w**-0.5)),
            (f"{prefix}.up_proj.weight", (inter, w), ("normal", w**-0.5)),
            (f"{prefix}.down_proj.weight", (w, inter), ("normal", inter**-0.5))]


def layer_specs(cfg: dict, i: int) -> list:
    """(HF name, torch shape, draw) of layer ``i``: matrices N(0, 1/fan_in), norm scales 1 + 0.1·N(0, 1)."""
    w, h, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    p, a = f"model.layers.{i}", f"model.layers.{i}.self_attn"
    specs = [
        (f"{p}.input_layernorm.weight", (w,), ("scale", 0.1)),
        (f"{p}.post_attention_layernorm.weight", (w,), ("scale", 0.1)),
        (f"{a}.q_proj.weight", (h * (dn + dr), w), ("normal", w**-0.5)),
        (f"{a}.kv_a_proj_with_mqa.weight", (r + dr, w), ("normal", w**-0.5)),
        (f"{a}.kv_a_layernorm.weight", (r,), ("scale", 0.1)),
        (f"{a}.kv_b_proj.weight", (h * (dn + dv), r), ("normal", r**-0.5)),
        (f"{a}.o_proj.weight", (w, h * dv), ("normal", (h * dv) ** -0.5)),
    ]
    if not is_moe(cfg, i):
        return specs + _swiglu_specs(f"{p}.mlp", w, cfg["intermediate_size"])
    inter = cfg["moe_intermediate_size"]
    specs.append((f"{p}.mlp.gate.weight", (cfg["n_routed_experts"], w), ("normal", w**-0.5)))
    for e in range(cfg["n_routed_experts"]):
        specs += _swiglu_specs(f"{p}.mlp.experts.{e}", w, inter)
    return specs + _swiglu_specs(f"{p}.mlp.shared_experts", w, inter * cfg["n_shared_experts"])


def outer_specs(cfg: dict) -> list:
    """The token embedding N(0, 1), the final norm and the untied head."""
    w, v = cfg["hidden_size"], cfg["vocab_size"]
    return [("model.embed_tokens.weight", (v, w), ("normal", 1.0)), ("model.norm.weight", (w,), ("scale", 0.1)),
            ("lm_head.weight", (v, w), ("normal", w**-0.5))]


def draw_layer(cfg: dict, i: int, seed: int, device, dtype) -> dict[str, torch.Tensor]:
    """Layer ``i``'s weights in ``dtype`` (the served type), as the program is given them."""
    return weights.draw(layer_specs(cfg, i), seed, LAYER_STREAM + i, device, dtype)


def draw_outer(cfg: dict, seed: int, device, dtype) -> dict[str, torch.Tensor]:
    return weights.draw(outer_specs(cfg), seed, OUTER_STREAM, device, dtype)


def rms_norm(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def silu(x):
    return x * torch.sigmoid(x)


def yarn_get_mscale(scale=1.0, mscale=1.0):
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(num_rotations, dim, base, max_positions):
    return (dim * math.log(max_positions / (num_rotations * 2 * math.pi))) / (2 * math.log(base))


def rope_tables(cfg: dict, t: int, device):
    """YaRN cos/sin (T, rope dim) (plain RoPE without ``rope_scaling``)."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    inv = 1.0 / base**exponent
    rs, scale = cfg.get("rope_scaling"), 1.0
    if rs:
        low = max(math.floor(_correction_dim(rs["beta_fast"], dim, base, rs["original_max_position_embeddings"])), 0)
        high = min(math.ceil(_correction_dim(rs["beta_slow"], dim, base, rs["original_max_position_embeddings"])),
                   dim - 1)
        high = high + 0.001 if low == high else high
        ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low) / (high - low)).clamp(0, 1)
        inv = inv / float(rs["factor"]) * ramp + inv * (1.0 - ramp)
        scale = yarn_get_mscale(rs["factor"], rs["mscale"]) / yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
    freqs = torch.outer(torch.arange(t, dtype=torch.float32, device=device), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos() * scale, emb.sin() * scale


def _rope(x, cos, sin):
    b, h, s, d = x.shape
    x = x.reshape(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return x * cos + torch.cat([-x[..., d // 2 :], x[..., : d // 2]], dim=-1) * sin


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale *= m * m
    return scale


def attention(p: dict, a: str, x, cfg, cos, sin, quant):
    b, t, _ = x.shape
    h, dn, dr, dv = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = ops.linear(x, p[f"{a}.q_proj.weight"], quant=quant).view(b, t, h, dn + dr).transpose(1, 2)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    c, k_pe = ops.linear(x, p[f"{a}.kv_a_proj_with_mqa.weight"], quant=quant).split([cfg["kv_lora_rank"], dr], -1)
    c = rms_norm(c, p[f"{a}.kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    kv = ops.linear(c, p[f"{a}.kv_b_proj.weight"], quant=quant).view(b, t, h, dn + dv).transpose(1, 2)
    k_nope, v = kv.split([dn, dv], dim=-1)
    query = torch.cat([q_nope, _rope(q_pe, cos, sin)], dim=-1)
    key = torch.cat([k_nope, _rope(k_pe.reshape(b, t, 1, dr).transpose(1, 2), cos, sin).expand(b, h, t, dr)], -1)
    causal = torch.triu(torch.ones(t, t, dtype=torch.bool, device=x.device), diagonal=1)
    out = torch.empty(b, t, h * dv, device=x.device)
    for s in range(0, b, ATTN_CHUNK):
        logits = (query[s : s + ATTN_CHUNK] @ key[s : s + ATTN_CHUNK].transpose(2, 3)) * softmax_scale(cfg)
        probs = torch.softmax(logits.masked_fill(causal, -math.inf), dim=-1)
        out[s : s + ATTN_CHUNK] = (probs @ v[s : s + ATTN_CHUNK]).transpose(1, 2).reshape(-1, t, h * dv)
        del logits, probs
    return ops.linear(out, p[f"{a}.o_proj.weight"], quant=quant)


def mlp(p: dict, prefix: str, x, quant, means: dict, taps):
    act = silu(ops.linear(x, p[f"{prefix}.gate_proj.weight"], quant=quant))
    if f"{prefix}.act_fn" in taps:
        means[f"{prefix}.act_fn"] = act.mean(dim=1)
    return ops.linear(act * ops.linear(x, p[f"{prefix}.up_proj.weight"], quant=quant),
                      p[f"{prefix}.down_proj.weight"], quant=quant)


def moe(p: dict, m: str, x, cfg, quant, means: dict, taps):
    """One MoE layer on its normed input (B, T, H); fills ``means`` with the tapped token means."""
    b, t, w = x.shape
    n_exp, k, inter = cfg["n_routed_experts"], cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
    x2 = x.reshape(b * t, w)
    scores = torch.softmax(ops.linear(x2, p[f"{m}.gate.weight"], quant=quant), dim=-1)
    top_w, top_i = torch.topk(scores, k, dim=-1)
    if k > 1 and cfg["norm_topk_prob"]:
        top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        top_w = top_w * cfg["routed_scaling_factor"]
    if f"{m}.gate" in taps:
        means[f"{m}.gate"] = scores.view(b, t, n_exp).mean(dim=1)
    tap = f"{m}.experts.act_fn" in taps
    acts = torch.zeros(b, n_exp, inter, device=x.device) if tap else None
    y = torch.zeros_like(x2)
    for e in range(n_exp):
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
            acts[:, e] = torch.zeros(b, inter, device=x.device).index_add_(0, rows // t, act)
    if tap:
        means[f"{m}.experts.act_fn"] = acts.view(b, n_exp * inter) / t
    return y.view(b, t, w) + mlp(p, f"{m}.shared_experts", x, quant, means, taps)


def token_means(cfg: dict, seed: int, device, tokens: torch.Tensor, taps, served, quant=None) -> dict:
    """(B, T) tokens → ``{tap: (B, C)}`` token means of the tapped activations, layer by layer.

    Each layer's weights are drawn in the served type ``served`` (as the
    program was given them), widened to float32, used over the whole block
    and freed before the next is drawn.
    """
    taps = tuple(taps)
    last = max(int(name.split(".")[2]) for name in taps)
    b, t = tokens.shape
    eps = cfg["rms_norm_eps"]
    outer = draw_outer(cfg, seed, device, served)
    x = outer["model.embed_tokens.weight"].float()[tokens.long()]
    del outer
    cos, sin = rope_tables(cfg, t, device)
    means: dict = {}
    for i in range(last + 1):
        p = weights.as_float32(draw_layer(cfg, i, seed, device, served))
        pre = f"model.layers.{i}"
        x = x + attention(p, f"{pre}.self_attn", rms_norm(x, p[f"{pre}.input_layernorm.weight"], eps), cfg, cos, sin,
                          quant)
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
