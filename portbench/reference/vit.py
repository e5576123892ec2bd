"""Plain ViT classifier (Dosovitskiy et al., arXiv:2010.11929), timm's names, in float32.

Patch convolution with bias, a class token, learned positions, pre-LN
blocks (LN → attention with a packed qkv → projection; LN → MLP with exact
GELU), LayerNorm eps 1e-6 (timm). ``forward`` returns two kinds of
component taps of a block:

- ``blocks.i.mlp.fc1``: the first MLP linear's output, before the GELU,
  (B, T, 4·width);
- ``blocks.i.attn.heads``: each head's contribution to the residual stream
  per token, ``‖a_h · W_O[:, h-th slice]ᵀ‖`` over the output features,
  (B, T, heads): the head's output through its slice of the projection.
"""

from __future__ import annotations

import torch

from portbench.reference import ops

LN_EPS = 1e-6


def block_specs(prefix: str, w: int) -> list:
    """One timm ``Block``'s tensors (also the SigLIP towers' blocks)."""
    return [
        (f"{prefix}.norm1.weight", (w,), ("scale", 0.1)), (f"{prefix}.norm1.bias", (w,), ("normal", 0.02)),
        (f"{prefix}.attn.qkv.weight", (3 * w, w), ("normal", w**-0.5)),
        (f"{prefix}.attn.qkv.bias", (3 * w,), ("normal", 0.02)),
        (f"{prefix}.attn.proj.weight", (w, w), ("normal", w**-0.5)),
        (f"{prefix}.attn.proj.bias", (w,), ("normal", 0.02)),
        (f"{prefix}.norm2.weight", (w,), ("scale", 0.1)), (f"{prefix}.norm2.bias", (w,), ("normal", 0.02)),
        (f"{prefix}.mlp.fc1.weight", (4 * w, w), ("normal", w**-0.5)),
        (f"{prefix}.mlp.fc1.bias", (4 * w,), ("normal", 0.02)),
        (f"{prefix}.mlp.fc2.weight", (w, 4 * w), ("normal", (4 * w) ** -0.5)),
        (f"{prefix}.mlp.fc2.bias", (w,), ("normal", 0.02)),
    ]


def param_specs(cfg: dict) -> list:
    """(name, torch shape, draw) of the classifier, timm's names."""
    w, p = cfg["width"], cfg["patch_size"]
    grid = cfg["image_size"] // p
    specs = [
        ("cls_token", (1, 1, w), ("normal", 0.02)),
        ("pos_embed", (1, grid * grid + 1, w), ("normal", 0.02)),
        ("patch_embed.proj.weight", (w, 3, p, p), ("normal", (3 * p * p) ** -0.5)),
        ("patch_embed.proj.bias", (w,), ("normal", 0.02)),
        ("norm.weight", (w,), ("scale", 0.1)), ("norm.bias", (w,), ("normal", 0.02)),
        ("head.weight", (cfg["num_classes"], w), ("normal", w**-0.5)),
        ("head.bias", (cfg["num_classes"],), ("normal", 0.02)),
    ]
    for i in range(cfg["depth"]):
        specs += block_specs(f"blocks.{i}", w)
    return specs


def forward(p: dict, x: torch.Tensor, taps: tuple[str, ...], cfg: dict, quant=None) -> dict:
    """Normalized NCHW images → ``{tap: (B, T, ·)}``; stops after the last tapped block."""
    w, heads = cfg["width"], cfg["heads"]
    x = ops.conv2d(x, p["patch_embed.proj.weight"], p["patch_embed.proj.bias"], stride=cfg["patch_size"],
                   quant=quant).flatten(2).transpose(1, 2)
    x = torch.cat([p["cls_token"].expand(x.shape[0], 1, w), x], dim=1) + p["pos_embed"]
    last = max(int(t.split(".")[1]) for t in taps)
    out = {}
    for i in range(last + 1):
        pre = f"blocks.{i}"
        h = ops.layer_norm(x, p[f"{pre}.norm1.weight"], p[f"{pre}.norm1.bias"], LN_EPS)
        q, k, v = ops.linear(h, p[f"{pre}.attn.qkv.weight"], p[f"{pre}.attn.qkv.bias"], quant).chunk(3, dim=-1)
        a = ops.attention(q, k, v, heads)
        if f"{pre}.attn.heads" in taps:
            b, t, _ = a.shape
            w_o = p[f"{pre}.attn.proj.weight"]  # (out, in); head h owns input columns h·hd … (h+1)·hd
            per_head = torch.einsum("bthc,ohc->btho", a.reshape(b, t, heads, w // heads),
                                    w_o.reshape(w, heads, w // heads))
            out[f"{pre}.attn.heads"] = torch.linalg.vector_norm(per_head, dim=-1)
        x = x + ops.linear(a, p[f"{pre}.attn.proj.weight"], p[f"{pre}.attn.proj.bias"], quant)
        h = ops.layer_norm(x, p[f"{pre}.norm2.weight"], p[f"{pre}.norm2.bias"], LN_EPS)
        h = ops.linear(h, p[f"{pre}.mlp.fc1.weight"], p[f"{pre}.mlp.fc1.bias"], quant)
        if f"{pre}.mlp.fc1" in taps:
            out[f"{pre}.mlp.fc1"] = h
        if i == last:
            break
        x = x + ops.linear(ops.gelu(h), p[f"{pre}.mlp.fc2.weight"], p[f"{pre}.mlp.fc2.bias"], quant)
    return out
