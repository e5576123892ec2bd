"""Functional torchvision-compatible RegNet (X and Y) with named taps.

Counterpart of ``semanticlens_tpu.models.regnet``, with the names of
torchvision's ``regnet_x_*`` / ``regnet_y_*`` (``stem.{0,1}``,
``trunk_output.block{s}.block{s}-{i}.f.{a,b,se,c}``, ``proj``, ``fc``), so
their state dicts load as they are:

- stage widths and depths are generated from ``(depth, w_0, w_a, w_m)`` as
  ``BlockParams.from_init_params`` does (:func:`generate_stage_params`: its
  float32 arithmetic and half-even rounding decide the widths);
- every stage downsamples (stride 2 in ``f.b`` and the 1×1 ``proj``); the
  stem is 3×3/s2 at width 32;
- ``f.b`` is a grouped 3×3 of ``width // group_width`` groups; the Y
  variants' SE squeezes to ``round(0.25 · block input width)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from semanticlens_tpu_torch.models.efficientnet import _make_divisible
from semanticlens_tpu_torch.models.layers import conv2d, global_avg_pool, linear, residual_add
from semanticlens_tpu_torch.models.zoo import ZooModel, cna_names, conv_bn_specs, se_names, se_specs
from semanticlens_tpu_torch.utils.device import resolve_device

# variant -> (depth, w_0, w_a, w_m, group_width, se_ratio): torchvision's regnet_{x,y}_*
# BlockParams.from_init_params arguments.
_VARIANTS = {
    "x_400mf": (22, 24, 24.48, 2.54, 16, None),
    "x_800mf": (16, 56, 35.73, 2.28, 16, None),
    "x_1_6gf": (18, 80, 34.01, 2.25, 24, None),
    "x_3_2gf": (25, 88, 26.31, 2.25, 48, None),
    "x_8gf": (23, 80, 49.56, 2.88, 120, None),
    "x_16gf": (22, 216, 55.59, 2.1, 128, None),
    "x_32gf": (23, 320, 69.86, 2.0, 168, None),
    "y_400mf": (16, 48, 27.89, 2.09, 8, 0.25),
    "y_800mf": (14, 56, 38.84, 2.4, 16, 0.25),
    "y_1_6gf": (27, 48, 20.71, 2.65, 24, 0.25),
    "y_3_2gf": (21, 80, 42.63, 2.66, 24, 0.25),
    "y_8gf": (17, 192, 76.82, 2.19, 56, 0.25),
    "y_16gf": (18, 200, 106.23, 2.48, 112, 0.25),
    "y_32gf": (20, 232, 115.89, 2.53, 232, 0.25),
}

_STEM_WIDTH = 32
_QUANT = 8


def generate_stage_params(depth: int, w_0: int, w_a: float, w_m: float, group_width: int):
    """torchvision ``BlockParams.from_init_params`` width generation.

    Returns ``(stage_widths, stage_depths, stage_group_widths)``. Float32
    intermediate math and half-even rounding reproduce torch's tensor ops;
    the group-compatibility quantization uses ``_make_divisible`` (the
    torchvision choice, which differs from pycls's round-to-nearest).
    """
    if w_a < 0 or w_0 <= 0 or w_m <= 1 or w_0 % 8 != 0:
        raise ValueError("invalid RegNet generation parameters")
    widths_cont = np.arange(depth, dtype=np.float32) * np.float32(w_a) + np.float32(w_0)
    capacity = np.round(np.log(widths_cont / np.float32(w_0)) / np.float32(math.log(w_m)))
    block_widths = (np.round(np.float32(w_0) * np.power(np.float32(w_m), capacity) / _QUANT) * _QUANT).astype(int)
    stage_widths: list[int] = []
    stage_depths: list[int] = []
    for w in block_widths.tolist():
        if stage_widths and stage_widths[-1] == w:
            stage_depths[-1] += 1
        else:
            stage_widths.append(w)
            stage_depths.append(1)
    groups = [min(group_width, w) for w in stage_widths]
    stage_widths = [_make_divisible(w, g) for w, g in zip(stage_widths, groups)]
    return stage_widths, stage_depths, groups


class _RegBlock:
    """One ``ResBottleneckBlock`` instance (bottleneck_multiplier = 1)."""

    def __init__(self, c_in, c_out, stride, group_width, se_ratio):
        self.c_in = c_in
        self.c_out = c_out
        self.stride = stride
        self.groups = c_out // group_width
        self.c_se = int(round(se_ratio * c_in)) if se_ratio else 0
        self.has_proj = c_in != c_out or stride != 1


class RegNet(ZooModel):
    """RegNetX / RegNetY with torchvision-compatible names.

    Parameters
    ----------
    variant : e.g. ``"y_400mf"``, ``"x_3_2gf"``: any of ``RegNet.VARIANTS``
        (torchvision's ``regnet_{variant}`` set).
    num_classes : classifier width (0 → headless pooled features).
    dtype : activation dtype (bfloat16 by default).
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    VARIANTS = tuple(_VARIANTS)

    def __init__(self, variant: str = "y_400mf", num_classes: int = 1000, *, dtype=torch.bfloat16, device=None):
        if variant not in _VARIANTS:
            raise ValueError(f"variant must be one of {sorted(_VARIANTS)}, got {variant!r}")
        self.variant = variant
        self.num_classes = num_classes
        self.dtype = dtype
        self.device = resolve_device(device)
        depth, w_0, w_a, w_m, group_width, se_ratio = _VARIANTS[variant]
        widths, depths, groups = generate_stage_params(depth, w_0, w_a, w_m, group_width)
        self.stage_widths = tuple(widths)
        self.stage_depths = tuple(depths)
        self.stages: list[list[_RegBlock]] = []
        c_in = _STEM_WIDTH
        for w, d, g in zip(widths, depths, groups):
            self.stages.append([_RegBlock(c_in if i == 0 else w, w, 2 if i == 0 else 1, g, se_ratio)
                                for i in range(d)])
            c_in = w
        self.num_features = widths[-1]
        self.module_names = tuple(self._enumerate_module_names())

    # ----------------------------------------------------------------- names
    @staticmethod
    def _block_names(base: str, blk: _RegBlock):
        names = [base] + (cna_names(f"{base}.proj", act=False) if blk.has_proj else [])
        names += [f"{base}.f"] + cna_names(f"{base}.f.a") + cna_names(f"{base}.f.b")
        if blk.c_se:
            names += se_names(f"{base}.f.se")
        return names + cna_names(f"{base}.f.c", act=False) + [f"{base}.activation"]

    def _enumerate_module_names(self):
        names = cna_names("stem") + ["trunk_output"]
        for si, blocks in enumerate(self.stages, start=1):
            stage = f"trunk_output.block{si}"
            names.append(stage)
            for bi, blk in enumerate(blocks):
                names += self._block_names(f"{stage}.block{si}-{bi}", blk)
        return names + ["avgpool"] + (["fc"] if self.num_classes else [])

    # ----------------------------------------------------------------- specs
    def _param_specs(self):
        specs = conv_bn_specs("stem", 3, 3, _STEM_WIDTH)
        for si, blocks in enumerate(self.stages, start=1):
            for bi, blk in enumerate(blocks):
                base = f"trunk_output.block{si}.block{si}-{bi}"
                if blk.has_proj:
                    specs += conv_bn_specs(f"{base}.proj", 1, blk.c_in, blk.c_out)
                specs += conv_bn_specs(f"{base}.f.a", 1, blk.c_in, blk.c_out)
                specs += conv_bn_specs(f"{base}.f.b", 3, blk.c_out // blk.groups, blk.c_out)
                if blk.c_se:
                    specs += se_specs(f"{base}.f.se", blk.c_out, blk.c_se)
                specs += conv_bn_specs(f"{base}.f.c", 1, blk.c_out, blk.c_out)
        if self.num_classes:
            specs += [("fc.weight", (self.num_features, self.num_classes), "fc"),
                      ("fc.bias", (self.num_classes,), "zeros")]
        return specs

    def _draw(self, name, shape, kind):
        """Kaiming-normal fan-out for every conv (SE 1×1s included), unit BN, normal(0, 0.01) fc:
        torchvision's scheme."""
        if kind == "conv":
            return "normal", math.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
        if kind == "se_fc":
            return "normal", math.sqrt(2.0 / shape[1])
        if kind == "fc":
            return "normal", 0.01
        return "const", 1.0 if kind == "bn_w" else 0.0

    # ----------------------------------------------------------------- apply
    def _block(self, params, x, base, blk: _RegBlock, tap):
        if blk.has_proj:
            sc = tap(f"{base}.proj.0", conv2d(x, params[f"{base}.proj.0.weight"], stride=blk.stride))
            sc = tap(f"{base}.proj", tap(f"{base}.proj.1", self._bn(params, f"{base}.proj.1", sc)))
        else:
            sc = x
        h = self._cna(params, x, f"{base}.f.a", tap, act=torch.relu)
        h = self._cna(params, h, f"{base}.f.b", tap, stride=blk.stride, kernel=3, groups=blk.groups, act=torch.relu)
        if blk.c_se:
            h = self._squeeze_excite(params, h, f"{base}.f.se", tap, squeeze=torch.relu)
        h = tap(f"{base}.f", self._cna(params, h, f"{base}.f.c", tap))
        return tap(base, tap(f"{base}.activation", torch.relu(residual_add(sc, h))))

    def _forward(self, params, x, tap):
        x = self._cna(params, x, "stem", tap, stride=2, kernel=3, act=torch.relu)
        for si, blocks in enumerate(self.stages, start=1):
            stage = f"trunk_output.block{si}"
            for bi, blk in enumerate(blocks):
                x = self._block(params, x, f"{stage}.block{si}-{bi}", blk, tap)
            x = tap(stage, x)
        x = tap("trunk_output", x)
        x = tap("avgpool", global_avg_pool(x)).flatten(1)
        if self.num_classes:
            x = tap("fc", linear(x, params["fc.weight"], params["fc.bias"]))
        return x

    def __repr__(self):
        return f"RegNet(variant={self.variant!r}, num_classes={self.num_classes})"
