"""Plain CLIP ViT image tower (Radford et al., arXiv:2103.00020), open_clip's names, in float32.

Patch convolution without bias, a class token, learned positions, a
pre-LayerNorm, residual blocks (LN → multi-head attention with a packed
in-projection → LN → MLP with OpenAI's quick GELU), LayerNorm of the class
token and the projection to the embedding. LayerNorm eps 1e-5 (OpenAI's
``nn.LayerNorm``). ``param_specs`` also lists the text tower, which the
program's constructor needs; ``encode_image`` never reads it.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import ops

LN_EPS = 1e-5


def _block_specs(prefix: str, w: int) -> list:
    return [
        (f"{prefix}.ln_1.weight", (w,), ("scale", 0.1)), (f"{prefix}.ln_1.bias", (w,), ("normal", 0.02)),
        (f"{prefix}.attn.in_proj_weight", (3 * w, w), ("normal", w**-0.5)),
        (f"{prefix}.attn.in_proj_bias", (3 * w,), ("normal", 0.02)),
        (f"{prefix}.attn.out_proj.weight", (w, w), ("normal", w**-0.5)),
        (f"{prefix}.attn.out_proj.bias", (w,), ("normal", 0.02)),
        (f"{prefix}.ln_2.weight", (w,), ("scale", 0.1)), (f"{prefix}.ln_2.bias", (w,), ("normal", 0.02)),
        (f"{prefix}.mlp.c_fc.weight", (4 * w, w), ("normal", w**-0.5)),
        (f"{prefix}.mlp.c_fc.bias", (4 * w,), ("normal", 0.02)),
        (f"{prefix}.mlp.c_proj.weight", (w, 4 * w), ("normal", (4 * w) ** -0.5)),
        (f"{prefix}.mlp.c_proj.bias", (w,), ("normal", 0.02)),
    ]


def param_specs(cfg: dict) -> list:
    """(name, torch shape, draw) of the image and text towers, open_clip's names."""
    v, t, e = cfg["vision"], cfg["text"], cfg["embed_dim"]
    w, grid = v["width"], v["image_size"] // v["patch_size"]
    specs = [
        ("visual.conv1.weight", (w, 3, v["patch_size"], v["patch_size"]), ("normal", (3 * v["patch_size"] ** 2) ** -0.5)),
        ("visual.class_embedding", (w,), ("normal", w**-0.5)),
        ("visual.positional_embedding", (grid * grid + 1, w), ("normal", w**-0.5)),
        ("visual.ln_pre.weight", (w,), ("scale", 0.1)), ("visual.ln_pre.bias", (w,), ("normal", 0.02)),
        ("visual.ln_post.weight", (w,), ("scale", 0.1)), ("visual.ln_post.bias", (w,), ("normal", 0.02)),
        ("visual.proj", (w, e), ("normal", w**-0.5)),
    ]
    for i in range(v["layers"]):
        specs += _block_specs(f"visual.transformer.resblocks.{i}", w)
    tw = t["width"]
    specs += [
        ("token_embedding.weight", (t["vocab_size"], tw), ("normal", 0.02)),
        ("positional_embedding", (t["context_length"], tw), ("normal", 0.01)),
        ("ln_final.weight", (tw,), ("scale", 0.1)), ("ln_final.bias", (tw,), ("normal", 0.02)),
        ("text_projection", (tw, e), ("normal", tw**-0.5)),
        ("logit_scale", (), ("const", math.log(1 / 0.07))),
    ]
    for i in range(t["layers"]):
        specs += _block_specs(f"transformer.resblocks.{i}", tw)
    return specs


def _block(p, prefix, x, heads, quant):
    h = ops.layer_norm(x, p[f"{prefix}.ln_1.weight"], p[f"{prefix}.ln_1.bias"], LN_EPS)
    q, k, v = ops.linear(h, p[f"{prefix}.attn.in_proj_weight"], p[f"{prefix}.attn.in_proj_bias"],
                         quant).chunk(3, dim=-1)
    a = ops.attention(q, k, v, heads)
    x = x + ops.linear(a, p[f"{prefix}.attn.out_proj.weight"], p[f"{prefix}.attn.out_proj.bias"], quant)
    h = ops.layer_norm(x, p[f"{prefix}.ln_2.weight"], p[f"{prefix}.ln_2.bias"], LN_EPS)
    h = ops.quick_gelu(ops.linear(h, p[f"{prefix}.mlp.c_fc.weight"], p[f"{prefix}.mlp.c_fc.bias"], quant))
    return x + ops.linear(h, p[f"{prefix}.mlp.c_proj.weight"], p[f"{prefix}.mlp.c_proj.bias"], quant)


def encode_image(p: dict, x: torch.Tensor, cfg: dict, quant=None) -> torch.Tensor:
    """Normalized NCHW float32 images → (B, embed_dim) float32."""
    v = cfg["vision"]
    x = ops.conv2d(x, p["visual.conv1.weight"], stride=v["patch_size"], quant=quant).flatten(2).transpose(1, 2)
    cls = p["visual.class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + p["visual.positional_embedding"]
    x = ops.layer_norm(x, p["visual.ln_pre.weight"], p["visual.ln_pre.bias"], LN_EPS)
    for i in range(v["layers"]):
        x = _block(p, f"visual.transformer.resblocks.{i}", x, v["heads"], quant)
    pooled = ops.layer_norm(x[:, 0], p["visual.ln_post.weight"], p["visual.ln_post.bias"], LN_EPS)
    return pooled @ p["visual.proj"]
