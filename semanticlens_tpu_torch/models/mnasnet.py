"""Functional torchvision-compatible MNASNet with named taps.

Counterpart of ``semanticlens_tpu.models.mnasnet``, with the names of
torchvision's ``mnasnet{0_5,0_75,1_0,1_3}`` (the flat ``layers.{0..16}``
trunk with nested ``layers.{8..13}.{i}.layers.{j}`` inverted residuals), so
their state dicts load as they are. Depths are ``_make_divisible(d·α)`` of
the base table; an inverted residual expands its input width by an integer
factor (no rounding); the pool is functional (``x.mean([2, 3])``), so there
is no ``avgpool`` module.
"""

from __future__ import annotations

import math

import torch

from semanticlens_tpu_torch.models.efficientnet import _make_divisible
from semanticlens_tpu_torch.models.layers import bn_param_specs, conv2d, linear, residual_add
from semanticlens_tpu_torch.models.zoo import ZooModel
from semanticlens_tpu_torch.utils.device import resolve_device

_BASE_DEPTHS = (32, 16, 24, 40, 80, 96, 192, 320)
# stacks at layers.8..13: (kernel, stride, expansion, repeats)
_STACKS = ((3, 2, 3, 3), (5, 2, 3, 3), (5, 2, 6, 3), (3, 1, 6, 2), (5, 2, 6, 4), (3, 1, 6, 1))
_VARIANTS = {"0_5": 0.5, "0_75": 0.75, "1_0": 1.0, "1_3": 1.3}
_HEAD = 1280


class _IRBlock:
    """One torchvision ``mnasnet._InvertedResidual`` instance."""

    def __init__(self, c_in, c_out, kernel, stride, expansion):
        self.c_in = c_in
        self.c_out = c_out
        self.kernel = kernel
        self.stride = stride
        self.c_mid = c_in * expansion
        self.residual = c_in == c_out and stride == 1


class MNASNet(ZooModel):
    """MNASNet α ∈ {0.5, 0.75, 1.0, 1.3} with torchvision names.

    Parameters
    ----------
    variant : "0_5" | "0_75" | "1_0" | "1_3" (torchvision ``mnasnet{v}``).
    num_classes : classifier width (0 → headless pooled 1280-d features).
    dtype : activation dtype (bfloat16 by default).
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    def __init__(self, variant: str = "1_0", num_classes: int = 1000, *, dtype=torch.bfloat16, device=None):
        if variant not in _VARIANTS:
            raise ValueError(f"variant must be one of {sorted(_VARIANTS)}, got {variant!r}")
        self.variant = variant
        self.num_classes = num_classes
        self.dtype = dtype
        self.device = resolve_device(device)
        alpha = _VARIANTS[variant]
        self.depths = tuple(_make_divisible(d * alpha) for d in _BASE_DEPTHS)
        self.stacks: list[list[_IRBlock]] = []
        for si, (kernel, stride, expansion, repeats) in enumerate(_STACKS):
            c_in, c_out = self.depths[si + 1], self.depths[si + 2]
            self.stacks.append([_IRBlock(c_in, c_out, kernel, stride, expansion)]
                               + [_IRBlock(c_out, c_out, kernel, 1, expansion) for _ in range(repeats - 1)])
        self.num_features = _HEAD
        self.module_names = tuple(self._enumerate_module_names())

    def _enumerate_module_names(self):
        names = ["layers"] + [f"layers.{i}" for i in range(8)]
        for si, blocks in enumerate(self.stacks):
            stack = f"layers.{8 + si}"
            names.append(stack)
            for bi in range(len(blocks)):
                base = f"{stack}.{bi}"
                names += [base, f"{base}.layers"] + [f"{base}.layers.{j}" for j in range(8)]
        names += [f"layers.{i}" for i in (14, 15, 16)]
        return names + (["classifier", "classifier.0", "classifier.1"] if self.num_classes else [])

    def _param_specs(self):
        d0, d1 = self.depths[0], self.depths[1]
        specs = [("layers.0.weight", (3, 3, 3, d0), "conv")] + bn_param_specs("layers.1", d0)
        specs += [("layers.3.weight", (3, 3, 1, d0), "dwconv")] + bn_param_specs("layers.4", d0)
        specs += [("layers.6.weight", (1, 1, d0, d1), "conv")] + bn_param_specs("layers.7", d1)
        for si, blocks in enumerate(self.stacks):
            for bi, blk in enumerate(blocks):
                base, k = f"layers.{8 + si}.{bi}.layers", blk.kernel
                specs += [(f"{base}.0.weight", (1, 1, blk.c_in, blk.c_mid), "conv")]
                specs += bn_param_specs(f"{base}.1", blk.c_mid)
                specs += [(f"{base}.3.weight", (k, k, 1, blk.c_mid), "dwconv")]
                specs += bn_param_specs(f"{base}.4", blk.c_mid)
                specs += [(f"{base}.6.weight", (1, 1, blk.c_mid, blk.c_out), "conv")]
                specs += bn_param_specs(f"{base}.7", blk.c_out)
        specs += [("layers.14.weight", (1, 1, self.depths[-1], _HEAD), "conv")] + bn_param_specs("layers.15", _HEAD)
        if self.num_classes:
            specs += [("classifier.1.weight", (_HEAD, self.num_classes), "fc"),
                      ("classifier.1.bias", (self.num_classes,), "zeros")]
        return specs

    def _draw(self, name, shape, kind):
        """Kaiming-normal fan-out convs, unit BN, normal(0.01) classifier (the JAX package's stand-in for
        torchvision's kaiming-uniform)."""
        if kind in ("conv", "dwconv"):
            return "normal", math.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
        if kind == "fc":
            return "normal", 0.01
        return "const", 1.0 if kind == "bn_w" else 0.0

    def _ir_block(self, params, x, base, blk: _IRBlock, tap):
        p = f"{base}.layers"
        h = tap(f"{p}.0", conv2d(x, params[f"{p}.0.weight"]))
        h = tap(f"{p}.1", self._bn(params, f"{p}.1", h))
        h = tap(f"{p}.2", torch.relu(h))
        h = tap(f"{p}.3", conv2d(h, params[f"{p}.3.weight"], stride=blk.stride, padding=blk.kernel // 2,
                                 groups=blk.c_mid))
        h = tap(f"{p}.4", self._bn(params, f"{p}.4", h))
        h = tap(f"{p}.5", torch.relu(h))
        h = tap(f"{p}.6", conv2d(h, params[f"{p}.6.weight"]))
        h = tap(p, tap(f"{p}.7", self._bn(params, f"{p}.7", h)))
        return tap(base, residual_add(x, h) if blk.residual else h)

    def _forward(self, params, x, tap):
        x = tap("layers.0", conv2d(x, params["layers.0.weight"], stride=2, padding=1))
        x = tap("layers.1", self._bn(params, "layers.1", x))
        x = tap("layers.2", torch.relu(x))
        x = tap("layers.3", conv2d(x, params["layers.3.weight"], padding=1, groups=self.depths[0]))
        x = tap("layers.4", self._bn(params, "layers.4", x))
        x = tap("layers.5", torch.relu(x))
        x = tap("layers.6", conv2d(x, params["layers.6.weight"]))
        x = tap("layers.7", self._bn(params, "layers.7", x))
        for si, blocks in enumerate(self.stacks):
            stack = f"layers.{8 + si}"
            for bi, blk in enumerate(blocks):
                x = self._ir_block(params, x, f"{stack}.{bi}", blk, tap)
            x = tap(stack, x)
        x = tap("layers.14", conv2d(x, params["layers.14.weight"]))
        x = tap("layers.15", self._bn(params, "layers.15", x))
        x = tap("layers", tap("layers.16", torch.relu(x)))
        x = torch.mean(x, dim=(2, 3))  # torchvision pools functionally
        if not self.num_classes:
            return x
        x = tap("classifier.0", x)  # Dropout: identity at inference
        return tap("classifier", tap("classifier.1", linear(x, params["classifier.1.weight"],
                                                             params["classifier.1.bias"])))

    def __repr__(self):
        return f"MNASNet(variant={self.variant!r}, num_classes={self.num_classes})"
