"""Functional Vision Transformer with named activation taps.

Counterpart of ``semanticlens_tpu.models.vit``: a pre-LN ViT classifier
(exact GELU, LayerNorm eps 1e-6) whose module and parameter names follow
timm's ``VisionTransformer`` (``blocks.3.mlp.fc1`` …) by default, or
torchvision's ``vit_b_16`` convention with ``naming="torchvision"``
(``conv_proj``, ``encoder.layers.encoder_layer_3.self_attention``,
``heads.head``, the packed ``in_proj_weight``). Parameters are in torch's
layouts (conv OIHW, linear (out, in)), so either kind of torch state dict
loads as it is. Input (B, H, W, 3); token taps are (B, T, D), as in the
JAX package. Each block's ``…attn.heads`` tap is the per-head contribution
norm (``layers.attn_out_projection``).
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch

from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch.models.base import SubjectModel, TapCollector
from semanticlens_tpu_torch.models.layers import (
    attn_out_projection,
    conv2d,
    gelu,
    layer_norm,
    linear,
    residual_add,
    scaled_dot_product_attention,
)
from semanticlens_tpu_torch.utils.device import resolve_device


def _to_torchvision(name: str) -> str | None:
    """Canonical (timm) module/param name → torchvision's, or None where torchvision has no such module."""
    if name == "patch_embed":
        return None
    if name == "blocks":
        return "encoder.layers"
    if name.startswith("patch_embed.proj"):
        return name.replace("patch_embed.proj", "conv_proj", 1)
    if name == "cls_token":
        return "class_token"
    if name == "pos_embed":
        return "encoder.pos_embedding"
    if name == "norm" or name.startswith("norm."):
        return name.replace("norm", "encoder.ln", 1)
    if name == "head" or name.startswith("head."):
        return name.replace("head", "heads.head", 1)
    if name.startswith("blocks."):
        name = "encoder.layers.encoder_layer_" + name[len("blocks."):]
        name = name.replace(".norm1", ".ln_1").replace(".norm2", ".ln_2")
        if name.endswith(".attn.qkv.weight"):
            return name.replace(".attn.qkv.weight", ".self_attention.in_proj_weight")
        if name.endswith(".attn.qkv.bias"):
            return name.replace(".attn.qkv.bias", ".self_attention.in_proj_bias")
        if name.endswith(".attn.qkv"):
            return None
        name = name.replace(".attn.proj", ".self_attention.out_proj")
        name = name.replace(".attn", ".self_attention")
        name = name.replace(".mlp.fc1", ".mlp.0").replace(".mlp.fc2", ".mlp.3")
        return name
    return name


class VisionTransformer(SubjectModel):
    """ViT classifier with timm- or torchvision-compatible names.

    Parameters
    ----------
    image_size, patch_size, width, depth, heads : architecture (defaults: ViT-B/16).
    num_classes : classifier width (0 → the pooled features, no head).
    dtype : activation dtype (bfloat16 by default).
    naming : "timm" (default) or "torchvision".
    device : where parameters live and the forward runs; ``None`` → the
        CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    LN_EPS = 1e-6

    _TV_VARIANTS = {
        "vit_b_16": (16, 768, 12, 12),
        "vit_b_32": (32, 768, 12, 12),
        "vit_l_16": (16, 1024, 24, 16),
        "vit_l_32": (32, 1024, 24, 16),
        "vit_h_14": (14, 1280, 32, 16),
    }

    def __init__(self, image_size: int = 224, patch_size: int = 16, width: int = 768, depth: int = 12,
                 heads: int = 12, num_classes: int = 1000, dtype=torch.bfloat16, naming: str = "timm",
                 device=None):
        if naming not in ("timm", "torchvision"):
            raise ValueError(f"naming must be 'timm' or 'torchvision', got {naming!r}")
        self.image_size = image_size
        self.patch_size = patch_size
        self.width = width
        self.depth = depth
        self.heads = heads
        self.num_classes = num_classes
        self.dtype = dtype
        self.naming = naming
        self.device = resolve_device(device)
        self.grid = image_size // patch_size
        self.module_names = tuple(self._enumerate_module_names())

    @classmethod
    def from_name(cls, name: str, *, image_size: int = 224, num_classes: int = 1000,
                  dtype=torch.bfloat16, device=None):
        """A torchvision-named ViT from its zoo name (``vit_b_16`` …)."""
        if name not in cls._TV_VARIANTS:
            raise ValueError(f"name must be one of {sorted(cls._TV_VARIANTS)}, got {name!r}")
        p, w, d, h = cls._TV_VARIANTS[name]
        return cls(image_size=image_size, patch_size=p, width=w, depth=d, heads=h,
                   num_classes=num_classes, dtype=dtype, naming="torchvision", device=device)

    def _n(self, name: str) -> str | None:
        return name if self.naming == "timm" else _to_torchvision(name)

    def _enumerate_module_names(self):
        names = ["patch_embed", "patch_embed.proj", "blocks"]
        for i in range(self.depth):
            p = f"blocks.{i}"
            names += [p, f"{p}.norm1", f"{p}.attn", f"{p}.attn.qkv", f"{p}.attn.heads", f"{p}.attn.proj",
                      f"{p}.norm2", f"{p}.mlp", f"{p}.mlp.fc1", f"{p}.mlp.fc2"]
        names += ["norm"]
        if self.num_classes:
            names += ["head"]  # headless towers never tap it
        if self.naming == "timm":
            return names
        translated = [t for t in (_to_torchvision(n) for n in names) if t is not None]
        translated.insert(0, "encoder")  # torchvision-only containers, tapped in apply
        if self.num_classes:
            translated.append("heads")
        return translated

    def _param_specs(self):
        """(name, shape, kind) in the JAX package's layout (conv HWIO, linear (in, out))."""
        w = self.width
        specs = [
            ("cls_token", (1, 1, w), "scaled"),
            ("pos_embed", (1, self.grid * self.grid + 1, w), "scaled"),
            ("patch_embed.proj.weight", (self.patch_size, self.patch_size, 3, w), "patch"),
            ("patch_embed.proj.bias", (w,), "zeros"),
            ("norm.weight", (w,), "ones"),
            ("norm.bias", (w,), "zeros"),
        ]
        for i in range(self.depth):
            p = f"blocks.{i}"
            specs += [
                (f"{p}.norm1.weight", (w,), "ones"),
                (f"{p}.norm1.bias", (w,), "zeros"),
                (f"{p}.attn.qkv.weight", (w, 3 * w), "attn"),
                (f"{p}.attn.qkv.bias", (3 * w,), "zeros"),
                (f"{p}.attn.proj.weight", (w, w), "proj"),
                (f"{p}.attn.proj.bias", (w,), "zeros"),
                (f"{p}.norm2.weight", (w,), "ones"),
                (f"{p}.norm2.bias", (w,), "zeros"),
                (f"{p}.mlp.fc1.weight", (w, 4 * w), "fc"),
                (f"{p}.mlp.fc1.bias", (4 * w,), "zeros"),
                (f"{p}.mlp.fc2.weight", (4 * w, w), "proj"),
                (f"{p}.mlp.fc2.bias", (w,), "zeros"),
            ]
        if self.num_classes:
            specs += [("head.weight", (w, self.num_classes), "proj"), ("head.bias", (self.num_classes,), "zeros")]
        if self.naming == "timm":
            return specs
        return [(_to_torchvision(n), shape, kind) for n, shape, kind in specs]

    def init_jax_layout(self, seed: int = 0) -> dict[str, np.ndarray]:
        """Random float32 numpy weights in the JAX package's layout, from ``seed``.

        The JAX package's scheme (unit/zero norms and biases, N(0, 0.02)
        tokens, N(0, 1/fan_in) matrices) drawn from ``np.random`` (the
        streams differ from ``jax.random``'s).
        """
        rng = np.random.default_rng(seed)
        params = {}
        for name, shape, kind in self._param_specs():
            if kind == "ones":
                params[name] = np.ones(shape, np.float32)
            elif kind == "zeros":
                params[name] = np.zeros(shape, np.float32)
            else:
                fan_in = shape[0] if len(shape) <= 2 else int(np.prod(shape[:-1]))
                std = 0.02 if kind == "scaled" else math.sqrt(1.0 / fan_in)
                params[name] = rng.standard_normal(shape, np.float32) * np.float32(std)
        return params

    def init(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Random weights from ``seed``, placed on the model's device."""
        return self.load_jax_params(self.init_jax_layout(seed))

    def load_jax_params(self, params: Mapping) -> dict[str, torch.Tensor]:
        """Weights in the JAX package's layout → the port's, placed for the forward."""
        return self.load_torch_state_dict(convert.vit_params_from_jax(params))

    def load_torch_state_dict(self, state_dict: Mapping) -> dict[str, torch.Tensor]:
        """A timm or torchvision ViT state dict (the active naming), placed for the forward.

        Matrices and the patch conv move to the compute dtype; tokens, norms
        and biases stay float32 (the forward casts them). Shapes are checked.
        """
        out = {}
        for name, shape, kind in self._param_specs():
            t = torch.as_tensor(state_dict[name])
            if len(shape) == 4:
                expected = (shape[3], shape[2], shape[0], shape[1])
            elif len(shape) == 2:
                expected = shape[::-1]
            else:
                expected = shape
            if tuple(t.shape) != tuple(expected):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != expected {expected}")
            matrix = len(shape) in (2, 4)
            out[name] = t.to(self.device, self.dtype if matrix else torch.float32)
        return out

    def apply(self, params: Mapping, x, tap_names: Sequence[str] = ()):
        """(B, H, W, 3) → (logits, taps). Token taps are (B, T, D)."""
        tapc = TapCollector(tap_names)

        def tap(name, value):
            t = self._n(name)
            return value if t is None else tapc(t, value)

        def p_(key):
            return params[self._n(key)]

        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = conv2d(x, p_("patch_embed.proj.weight"), p_("patch_embed.proj.bias"), stride=self.patch_size)
        b, w = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)  # (B, gh·gw, D), row-major patches as the JAX reshape
        x = tap("patch_embed.proj", x)
        x = tap("patch_embed", x)
        cls = p_("cls_token").to(self.dtype).expand(b, 1, w)
        x = torch.cat([cls, x], dim=1) + p_("pos_embed").to(self.dtype)

        for i in range(self.depth):
            p = f"blocks.{i}"
            h = tap(f"{p}.norm1", layer_norm(x, p_(f"{p}.norm1.weight"), p_(f"{p}.norm1.bias"), eps=self.LN_EPS))
            qkv = tap(f"{p}.attn.qkv", linear(h, p_(f"{p}.attn.qkv.weight"), p_(f"{p}.attn.qkv.bias")))
            q, k, v = qkv[..., :w], qkv[..., w : 2 * w], qkv[..., 2 * w :]
            h = scaled_dot_product_attention(q, k, v, self.heads)
            h = attn_out_projection(tapc, self._n(f"{p}.attn.heads"), self._n(f"{p}.attn.proj"), h,
                                    p_(f"{p}.attn.proj.weight"), p_(f"{p}.attn.proj.bias"), self.heads)
            h = tap(f"{p}.attn", h)
            x = residual_add(x, h)
            h = tap(f"{p}.norm2", layer_norm(x, p_(f"{p}.norm2.weight"), p_(f"{p}.norm2.bias"), eps=self.LN_EPS))
            h = tap(f"{p}.mlp.fc1", linear(h, p_(f"{p}.mlp.fc1.weight"), p_(f"{p}.mlp.fc1.bias")))
            h = gelu(h, approximate=False)
            h = tap(f"{p}.mlp.fc2", linear(h, p_(f"{p}.mlp.fc2.weight"), p_(f"{p}.mlp.fc2.bias")))
            h = tap(f"{p}.mlp", h)
            x = residual_add(x, h)
            x = tap(p, x)
        x = tap("blocks", x)

        x = tap("norm", layer_norm(x, p_("norm.weight"), p_("norm.bias"), eps=self.LN_EPS))
        if self.naming == "torchvision":
            x = tapc("encoder", x)  # torchvision's Encoder output is post-LN
        pooled = x[:, 0]
        if self.num_classes:
            logits = tap("head", linear(pooled, p_("head.weight"), p_("head.bias")))
            if self.naming == "torchvision":
                logits = tapc("heads", logits)
            return logits, tapc.taps
        return pooled, tapc.taps

    def __repr__(self):
        return (f"VisionTransformer(image_size={self.image_size}, patch_size={self.patch_size}, "
                f"width={self.width}, depth={self.depth}, num_classes={self.num_classes}, "
                f"naming={self.naming!r})")
