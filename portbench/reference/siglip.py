"""Plain SigLIP 2 ViT-B/16 image tower (Tschannen et al., arXiv:2502.14786; timm's
``vit_base_patch16_siglip_224`` as packaged in ``hf-hub:timm/ViT-B-16-SigLIP2``), in float32.

Patch convolution with bias, learned positions and no class token, timm
pre-LN blocks with exact GELU, a final LayerNorm, then the MAP head
(``AttentionPoolLatent``): one learned latent query attends over the patch
tokens (q from the latent, packed kv from the tokens, a projection), and
an MLP on its LayerNorm is added back. timm builds every LayerNorm of this
tower with eps 1e-6. ``param_specs`` also lists the text tower, which the
program's constructor needs; ``encode_image`` never reads it.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import ops
from portbench.reference.vit import block_specs

LN_EPS = 1e-6


def param_specs(cfg: dict) -> list:
    """(name, torch shape, draw) of the image and text towers, the SigLIP state dict's names."""
    v, t = cfg["vision"], cfg["text"]
    w, p = v["width"], v["patch_size"]
    grid = v["image_size"] // p
    ap = "visual.attn_pool"
    specs = [
        ("visual.patch_embed.proj.weight", (w, 3, p, p), ("normal", (3 * p * p) ** -0.5)),
        ("visual.patch_embed.proj.bias", (w,), ("normal", 0.02)),
        ("visual.pos_embed", (grid * grid, w), ("normal", 0.02)),
        ("visual.norm.weight", (w,), ("scale", 0.1)), ("visual.norm.bias", (w,), ("normal", 0.02)),
        (f"{ap}.latent", (1, w), ("normal", 0.02)),
        (f"{ap}.q.weight", (w, w), ("normal", w**-0.5)), (f"{ap}.q.bias", (w,), ("normal", 0.02)),
        (f"{ap}.kv.weight", (2 * w, w), ("normal", w**-0.5)), (f"{ap}.kv.bias", (2 * w,), ("normal", 0.02)),
        (f"{ap}.proj.weight", (w, w), ("normal", w**-0.5)), (f"{ap}.proj.bias", (w,), ("normal", 0.02)),
        (f"{ap}.norm.weight", (w,), ("scale", 0.1)), (f"{ap}.norm.bias", (w,), ("normal", 0.02)),
        (f"{ap}.mlp.fc1.weight", (4 * w, w), ("normal", w**-0.5)), (f"{ap}.mlp.fc1.bias", (4 * w,), ("normal", 0.02)),
        (f"{ap}.mlp.fc2.weight", (w, 4 * w), ("normal", (4 * w) ** -0.5)),
        (f"{ap}.mlp.fc2.bias", (w,), ("normal", 0.02)),
    ]
    for i in range(v["layers"]):
        specs += block_specs(f"visual.blocks.{i}", w)
    tw = t["width"]
    specs += [
        ("text.token_embedding.weight", (t["vocab_size"], tw), ("normal", 0.02)),
        ("text.positional_embedding", (t["context_length"], tw), ("normal", 0.02)),
        ("text.norm.weight", (tw,), ("scale", 0.1)), ("text.norm.bias", (tw,), ("normal", 0.02)),
        ("text.head.weight", (cfg["embed_dim"], tw), ("normal", tw**-0.5)),
        ("text.head.bias", (cfg["embed_dim"],), ("normal", 0.02)),
        ("logit_scale", (), ("const", math.log(10.0))),
        ("logit_bias", (), ("const", -10.0)),
    ]
    for i in range(t["layers"]):
        specs += block_specs(f"text.blocks.{i}", tw)
    return specs


def encode_image(p: dict, x: torch.Tensor, cfg: dict, quant=None) -> torch.Tensor:
    """Normalized NCHW float32 images → (B, width) float32."""
    v = cfg["vision"]
    w, heads = v["width"], v["heads"]
    x = ops.conv2d(x, p["visual.patch_embed.proj.weight"], p["visual.patch_embed.proj.bias"],
                   stride=v["patch_size"], quant=quant).flatten(2).transpose(1, 2)
    x = x + p["visual.pos_embed"]
    for i in range(v["layers"]):
        pre = f"visual.blocks.{i}"
        h = ops.layer_norm(x, p[f"{pre}.norm1.weight"], p[f"{pre}.norm1.bias"], LN_EPS)
        q, k, vv = ops.linear(h, p[f"{pre}.attn.qkv.weight"], p[f"{pre}.attn.qkv.bias"], quant).chunk(3, dim=-1)
        x = x + ops.linear(ops.attention(q, k, vv, heads), p[f"{pre}.attn.proj.weight"], p[f"{pre}.attn.proj.bias"],
                           quant)
        h = ops.layer_norm(x, p[f"{pre}.norm2.weight"], p[f"{pre}.norm2.bias"], LN_EPS)
        h = ops.gelu(ops.linear(h, p[f"{pre}.mlp.fc1.weight"], p[f"{pre}.mlp.fc1.bias"], quant))
        x = x + ops.linear(h, p[f"{pre}.mlp.fc2.weight"], p[f"{pre}.mlp.fc2.bias"], quant)
    x = ops.layer_norm(x, p["visual.norm.weight"], p["visual.norm.bias"], LN_EPS)
    ap = "visual.attn_pool"
    q = ops.linear(p[f"{ap}.latent"].expand(x.shape[0], 1, w), p[f"{ap}.q.weight"], p[f"{ap}.q.bias"], quant)
    k, vv = ops.linear(x, p[f"{ap}.kv.weight"], p[f"{ap}.kv.bias"], quant).chunk(2, dim=-1)
    pooled = ops.linear(ops.attention(q, k, vv, heads), p[f"{ap}.proj.weight"], p[f"{ap}.proj.bias"], quant)[:, 0]
    h = ops.layer_norm(pooled, p[f"{ap}.norm.weight"], p[f"{ap}.norm.bias"], LN_EPS)
    h = ops.linear(ops.gelu(ops.linear(h, p[f"{ap}.mlp.fc1.weight"], p[f"{ap}.mlp.fc1.bias"], quant)),
                   p[f"{ap}.mlp.fc2.weight"], p[f"{ap}.mlp.fc2.bias"], quant)
    return pooled + h
