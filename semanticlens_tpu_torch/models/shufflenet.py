"""Functional torchvision-compatible ShuffleNetV2 with named taps.

Counterpart of ``semanticlens_tpu.models.shufflenet``: ×0.5/×1.0/×1.5/×2.0
with the module and parameter names of torchvision's ``shufflenet_v2_x*``
(``conv1.{0,1}``, ``stage{2,3,4}.{i}.branch{1,2}.{j}``, ``conv5``, ``fc``),
so their state dicts load as they are:

- stride-1 units split the channels (the first half bypasses, the second
  runs ``branch2``); stride-2 units run both branches on the whole input,
  ``branch1`` (depthwise 3×3/s2 → 1×1) only there. torchvision's stride-1
  units own an empty ``branch1`` that is never called, so it is not among
  ``module_names``;
- every unit ends with ``channel_shuffle(·, 2)``: in NCHW the channel
  permutation is the (B, g, C/g, H, W) → (B, C/g, g, H, W) swap, the JAX
  package's NHWC (…, g, C/g) → (…, C/g, g), run here on the NHWC view;
- the trunk pools with ``x.mean([2, 3])`` (no ``avgpool`` module); convs
  are bias-free, BN eps 1e-5.

Under LRP the split, concatenation and shuffle are index maps: autograd
hands relevance through them unchanged, as the JAX package's VJPs do.
"""

from __future__ import annotations

import math

import torch

from semanticlens_tpu_torch.models.layers import bn_param_specs, conv2d, linear, max_pool
from semanticlens_tpu_torch.models.zoo import ZooModel
from semanticlens_tpu_torch.utils.device import resolve_device

_REPEATS = (4, 8, 4)
# variant -> stage output channels (stem, stage2, stage3, stage4, conv5)
_VARIANTS = {
    "x0_5": (24, 48, 96, 192, 1024),
    "x1_0": (24, 116, 232, 464, 1024),
    "x1_5": (24, 176, 352, 704, 1024),
    "x2_0": (24, 244, 488, 976, 2048),
}


def channel_shuffle(x, groups: int = 2):
    """torchvision ``channel_shuffle`` on NCHW: channel g·(C/groups)+a moves to a·groups+g.

    The (g, C/g) → (C/g, g) swap runs on the NHWC view, so a channels_last
    input stays channels_last (one copy).
    """
    b, c, h, w = x.shape
    nhwc = x.permute(0, 2, 3, 1).reshape(b, h, w, groups, c // groups).transpose(3, 4)
    return nhwc.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _Unit:
    """One InvertedResidual instance."""

    def __init__(self, c_in, c_out, stride):
        self.c_in = c_in
        self.c_out = c_out
        self.stride = stride
        self.branch = c_out // 2
        self.downsample = stride > 1


class ShuffleNetV2(ZooModel):
    """ShuffleNetV2 ×0.5/×1.0/×1.5/×2.0 with torchvision-compatible names.

    Parameters
    ----------
    variant : "x0_5" | "x1_0" | "x1_5" | "x2_0".
    num_classes : classifier width (0 → headless pooled features).
    dtype : activation dtype (bfloat16 by default).
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    def __init__(self, variant: str = "x1_0", num_classes: int = 1000, *, dtype=torch.bfloat16, device=None):
        if variant not in _VARIANTS:
            raise ValueError(f"variant must be one of {sorted(_VARIANTS)}, got {variant!r}")
        self.variant = variant
        self.num_classes = num_classes
        self.dtype = dtype
        self.device = resolve_device(device)
        chans = _VARIANTS[variant]
        self.stem_ch, self.conv5_ch = chans[0], chans[4]
        self.stages: list[list[_Unit]] = []
        c_in = self.stem_ch
        for reps, c_out in zip(_REPEATS, chans[1:4]):
            self.stages.append([_Unit(c_in, c_out, 2)] + [_Unit(c_out, c_out, 1) for _ in range(reps - 1)])
            c_in = c_out
        self.num_features = self.conv5_ch
        self.module_names = tuple(self._enumerate_module_names())

    # ------------------------------------------------------------------ names
    def _enumerate_module_names(self):
        names = ["conv1", "conv1.0", "conv1.1", "conv1.2", "maxpool"]
        for si, units in enumerate(self.stages, start=2):
            names.append(f"stage{si}")
            for ui, unit in enumerate(units):
                base = f"stage{si}.{ui}"
                names.append(base)
                if unit.downsample:
                    names += [f"{base}.branch1"] + [f"{base}.branch1.{j}" for j in range(5)]
                names += [f"{base}.branch2"] + [f"{base}.branch2.{j}" for j in range(8)]
        names += ["conv5", "conv5.0", "conv5.1", "conv5.2"]
        return names + (["fc"] if self.num_classes else [])

    # ------------------------------------------------------------------ params
    def _param_specs(self):
        specs = [("conv1.0.weight", (3, 3, 3, self.stem_ch), "conv")] + bn_param_specs("conv1.1", self.stem_ch)
        for si, units in enumerate(self.stages, start=2):
            for ui, unit in enumerate(units):
                base, bf = f"stage{si}.{ui}", unit.branch
                if unit.downsample:
                    specs += [(f"{base}.branch1.0.weight", (3, 3, 1, unit.c_in), "dwconv")]
                    specs += bn_param_specs(f"{base}.branch1.1", unit.c_in)
                    specs += [(f"{base}.branch1.2.weight", (1, 1, unit.c_in, bf), "conv")]
                    specs += bn_param_specs(f"{base}.branch1.3", bf)
                b2_in = unit.c_in if unit.downsample else bf
                specs += [(f"{base}.branch2.0.weight", (1, 1, b2_in, bf), "conv")]
                specs += bn_param_specs(f"{base}.branch2.1", bf)
                specs += [(f"{base}.branch2.3.weight", (3, 3, 1, bf), "dwconv")]
                specs += bn_param_specs(f"{base}.branch2.4", bf)
                specs += [(f"{base}.branch2.5.weight", (1, 1, bf, bf), "conv")]
                specs += bn_param_specs(f"{base}.branch2.6", bf)
        specs += [("conv5.0.weight", (1, 1, self.stages[-1][-1].c_out, self.conv5_ch), "conv")]
        specs += bn_param_specs("conv5.1", self.conv5_ch)
        if self.num_classes:
            specs += [("fc.weight", (self.conv5_ch, self.num_classes), "fc"), ("fc.bias", (self.num_classes,), "zeros")]
        return specs

    def _draw(self, name, shape, kind):
        """Kaiming-normal fan-out convs, normal(0.01) fc, unit BN: the JAX package's scheme."""
        if kind in ("conv", "dwconv"):
            return "normal", math.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
        if kind == "fc":
            return "normal", 0.01
        return "const", 1.0 if kind == "bn_w" else 0.0

    # ------------------------------------------------------------------ forward
    def _branch1(self, params, x, base, unit, tap):
        p = f"{base}.branch1"
        h = tap(f"{p}.0", conv2d(x, params[f"{p}.0.weight"], stride=unit.stride, padding=1, groups=unit.c_in))
        h = tap(f"{p}.1", self._bn(params, f"{p}.1", h))
        h = tap(f"{p}.2", conv2d(h, params[f"{p}.2.weight"]))
        h = tap(f"{p}.3", self._bn(params, f"{p}.3", h))
        return tap(p, tap(f"{p}.4", torch.relu(h)))

    def _branch2(self, params, x, base, unit, tap):
        p = f"{base}.branch2"
        h = tap(f"{p}.0", conv2d(x, params[f"{p}.0.weight"]))
        h = tap(f"{p}.1", self._bn(params, f"{p}.1", h))
        h = tap(f"{p}.2", torch.relu(h))
        h = tap(f"{p}.3", conv2d(h, params[f"{p}.3.weight"], stride=unit.stride, padding=1, groups=unit.branch))
        h = tap(f"{p}.4", self._bn(params, f"{p}.4", h))
        h = tap(f"{p}.5", conv2d(h, params[f"{p}.5.weight"]))
        h = tap(f"{p}.6", self._bn(params, f"{p}.6", h))
        return tap(p, tap(f"{p}.7", torch.relu(h)))

    def _unit(self, params, x, base, unit: _Unit, tap):
        if unit.downsample:
            out = torch.cat([self._branch1(params, x, base, unit, tap), self._branch2(params, x, base, unit, tap)], 1)
        else:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self._branch2(params, x2, base, unit, tap)], 1)
        return tap(base, channel_shuffle(out, 2))

    def _forward(self, params, x, tap):
        x = tap("conv1.0", conv2d(x, params["conv1.0.weight"], stride=2, padding=1))
        x = tap("conv1.1", self._bn(params, "conv1.1", x))
        x = tap("conv1", tap("conv1.2", torch.relu(x)))
        x = tap("maxpool", max_pool(x, window=3, stride=2, padding=1))
        for si, units in enumerate(self.stages, start=2):
            for ui, unit in enumerate(units):
                x = self._unit(params, x, f"stage{si}.{ui}", unit, tap)
            x = tap(f"stage{si}", x)
        x = tap("conv5.0", conv2d(x, params["conv5.0.weight"]))
        x = tap("conv5.1", self._bn(params, "conv5.1", x))
        x = tap("conv5", tap("conv5.2", torch.relu(x)))
        x = torch.mean(x, dim=(2, 3))  # torchvision pools functionally
        if self.num_classes:
            return tap("fc", linear(x, params["fc.weight"], params["fc.bias"]))
        return x

    def __repr__(self):
        return f"ShuffleNetV2(variant={self.variant!r}, num_classes={self.num_classes})"
