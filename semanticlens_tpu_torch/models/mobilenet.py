"""Functional torchvision-compatible MobileNetV2 / MobileNetV3 with named taps.

Counterpart of ``semanticlens_tpu.models.mobilenet``, with the module and
parameter names of torchvision's ``mobilenet_v2`` / ``mobilenet_v3_large`` /
``mobilenet_v3_small``, so their state dicts load as they are:

- widths go through ``_make_divisible(v, 8)``; ``width_mult`` scales every
  block and V2's tail (``max(1280, 1280·width)``);
- V2's inverted residual is ``conv.{0,1}`` Conv2dNormActivations (ReLU6)
  then a raw ``Conv2d`` + ``BatchNorm2d`` projection; V3's ends with a
  Conv2dNormActivation without activation;
- V3: BN eps 1e-3, hardswish or ReLU per row, an SE squeeze of
  ``_make_divisible(expanded // 4)`` with a ReLU squeeze and a Hardsigmoid
  gate;
- ReLU6 and hardswish carry the LRP pass-through rule (``layers.relu6`` /
  ``layers.hardswish``); dropout is the identity at inference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from semanticlens_tpu_torch.models.efficientnet import _make_divisible
from semanticlens_tpu_torch.models.layers import (
    bn_param_specs,
    conv2d,
    global_avg_pool,
    hardswish,
    linear,
    relu6,
    residual_add,
)
from semanticlens_tpu_torch.models.zoo import ZooModel, cna_names, conv_bn_specs, se_names, se_specs
from semanticlens_tpu_torch.utils.device import resolve_device

# MobileNetV2 inverted-residual settings: (expand_t, out_ch, repeats, stride)
_V2_STAGES = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

# MobileNetV3 bneck rows: (c_in, kernel, c_expand, c_out, use_se, act, stride);
# act: "RE" = ReLU, "HS" = hardswish (torchvision _mobilenet_v3_conf).
_V3_LARGE = (
    (16, 3, 16, 16, False, "RE", 1),
    (16, 3, 64, 24, False, "RE", 2),
    (24, 3, 72, 24, False, "RE", 1),
    (24, 5, 72, 40, True, "RE", 2),
    (40, 5, 120, 40, True, "RE", 1),
    (40, 5, 120, 40, True, "RE", 1),
    (40, 3, 240, 80, False, "HS", 2),
    (80, 3, 200, 80, False, "HS", 1),
    (80, 3, 184, 80, False, "HS", 1),
    (80, 3, 184, 80, False, "HS", 1),
    (80, 3, 480, 112, True, "HS", 1),
    (112, 3, 672, 112, True, "HS", 1),
    (112, 5, 672, 160, True, "HS", 2),
    (160, 5, 960, 160, True, "HS", 1),
    (160, 5, 960, 160, True, "HS", 1),
)
_V3_SMALL = (
    (16, 3, 16, 16, True, "RE", 2),
    (16, 3, 72, 24, False, "RE", 2),
    (24, 3, 88, 24, False, "RE", 1),
    (24, 5, 96, 40, True, "HS", 2),
    (40, 5, 240, 40, True, "HS", 1),
    (40, 5, 240, 40, True, "HS", 1),
    (40, 5, 120, 48, True, "HS", 1),
    (48, 5, 144, 48, True, "HS", 1),
    (48, 5, 288, 96, True, "HS", 2),
    (96, 5, 576, 96, True, "HS", 1),
    (96, 5, 576, 96, True, "HS", 1),
)
# variant -> (rows, classifier hidden width)
_V3_VARIANTS = {"large": (_V3_LARGE, 1280), "small": (_V3_SMALL, 1024)}


class _MobileNetBase(ZooModel):
    """The init kinds the two generations share."""

    def _draw(self, name, shape, kind):
        """Kaiming-normal fan-out for every conv (SE 1×1s included), unit BN, normal(0, 0.01) linears:
        torchvision's scheme."""
        if kind in ("conv", "dwconv"):
            return "normal", math.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
        if kind == "se_fc":
            return "normal", math.sqrt(2.0 / shape[1])
        if kind == "fc":
            return "normal", 0.01
        return "const", 1.0 if kind == "bn_w" else 0.0


class _V2Block:
    """One V2 InvertedResidual after width scaling."""

    def __init__(self, c_in, c_out, expand, stride):
        self.c_in = c_in
        self.c_out = c_out
        self.stride = stride
        self.c_mid = int(round(c_in * expand))
        self.has_expand = expand != 1
        self.i_dw = 1 if self.has_expand else 0
        self.i_proj = self.i_dw + 1  # raw Conv2d
        self.i_bn = self.i_proj + 1  # raw BatchNorm2d
        self.residual = stride == 1 and c_in == c_out


class MobileNetV2(_MobileNetBase):
    """MobileNetV2 with torchvision-compatible names.

    Parameters
    ----------
    num_classes : classifier width (0 → headless pooled features).
    width_mult : torchvision's channel multiplier (divisible-by-8 rounding).
    dtype : activation dtype (bfloat16 by default).
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    bn_eps = 1e-5

    def __init__(self, num_classes: int = 1000, *, width_mult: float = 1.0, dtype=torch.bfloat16, device=None):
        self.num_classes = num_classes
        self.width_mult = width_mult
        self.dtype = dtype
        self.device = resolve_device(device)
        self.stem_ch = _make_divisible(32 * width_mult)
        self.head_ch = _make_divisible(1280 * max(1.0, width_mult))
        self.blocks: list[_V2Block] = []
        c_in = self.stem_ch
        for t, c, n, s in _V2_STAGES:
            c_out = _make_divisible(c * width_mult)
            for j in range(n):
                self.blocks.append(_V2Block(c_in, c_out, t, s if j == 0 else 1))
                c_in = c_out
        self.num_features = self.head_ch
        self.module_names = tuple(self._enumerate_module_names())

    def _enumerate_module_names(self):
        names = ["features"] + cna_names("features.0")
        for bi, blk in enumerate(self.blocks, start=1):
            base = f"features.{bi}"
            names += [base, f"{base}.conv"]
            if blk.has_expand:
                names += cna_names(f"{base}.conv.0")
            names += cna_names(f"{base}.conv.{blk.i_dw}") + [f"{base}.conv.{blk.i_proj}", f"{base}.conv.{blk.i_bn}"]
        names += cna_names(f"features.{len(self.blocks) + 1}")
        return names + (["classifier", "classifier.0", "classifier.1"] if self.num_classes else [])

    def _param_specs(self):
        specs = conv_bn_specs("features.0", 3, 3, self.stem_ch)
        for bi, blk in enumerate(self.blocks, start=1):
            base = f"features.{bi}.conv"
            if blk.has_expand:
                specs += conv_bn_specs(f"{base}.0", 1, blk.c_in, blk.c_mid)
            specs += conv_bn_specs(f"{base}.{blk.i_dw}", 3, blk.c_mid, blk.c_mid, kind="dwconv")
            specs.append((f"{base}.{blk.i_proj}.weight", (1, 1, blk.c_mid, blk.c_out), "conv"))
            specs += bn_param_specs(f"{base}.{blk.i_bn}", blk.c_out)
        specs += conv_bn_specs(f"features.{len(self.blocks) + 1}", 1, self.blocks[-1].c_out, self.head_ch)
        if self.num_classes:
            specs += [("classifier.1.weight", (self.head_ch, self.num_classes), "fc"),
                      ("classifier.1.bias", (self.num_classes,), "zeros")]
        return specs

    def _inverted_residual(self, params, x, base, blk: _V2Block, tap):
        h = x
        if blk.has_expand:
            h = self._cna(params, h, f"{base}.conv.0", tap, act=relu6)
        h = self._cna(params, h, f"{base}.conv.{blk.i_dw}", tap, stride=blk.stride, kernel=3, groups=blk.c_mid,
                      act=relu6)
        h = tap(f"{base}.conv.{blk.i_proj}", conv2d(h, params[f"{base}.conv.{blk.i_proj}.weight"]))
        bn = f"{base}.conv.{blk.i_bn}"
        h = tap(f"{base}.conv", tap(bn, self._bn(params, bn, h)))
        return tap(base, residual_add(x, h) if blk.residual else h)

    def _forward(self, params, x, tap):
        x = self._cna(params, x, "features.0", tap, stride=2, kernel=3, act=relu6)
        for bi, blk in enumerate(self.blocks, start=1):
            x = self._inverted_residual(params, x, f"features.{bi}", blk, tap)
        x = self._cna(params, x, f"features.{len(self.blocks) + 1}", tap, act=relu6)
        x = tap("features", x)
        x = tap("classifier.0", global_avg_pool(x).flatten(1))  # dropout: identity at inference
        if self.num_classes:
            x = tap("classifier", tap("classifier.1", linear(x, params["classifier.1.weight"],
                                                              params["classifier.1.bias"])))
        return x

    def __repr__(self):
        w = f", width_mult={self.width_mult}" if self.width_mult != 1.0 else ""
        return f"MobileNetV2(num_classes={self.num_classes}{w})"


class _V3Block:
    """One V3 bneck row after width scaling."""

    def __init__(self, c_in, kernel, c_mid, c_out, use_se, act, stride, width_mult):
        def adjust(c):
            return _make_divisible(c * width_mult)

        self.c_in = adjust(c_in)
        self.kernel = kernel
        self.c_mid = adjust(c_mid)
        self.c_out = adjust(c_out)
        self.use_se = use_se
        self.act = act  # "RE" | "HS"
        self.stride = stride
        self.c_se = _make_divisible(self.c_mid // 4) if use_se else 0
        self.has_expand = self.c_mid != self.c_in
        self.i_dw = 1 if self.has_expand else 0
        self.i_se = self.i_dw + 1 if use_se else -1
        self.i_proj = self.i_dw + (2 if use_se else 1)
        self.residual = stride == 1 and self.c_in == self.c_out


class MobileNetV3(_MobileNetBase):
    """MobileNetV3-Large/-Small with torchvision-compatible names.

    Parameters
    ----------
    variant : "large" | "small".
    num_classes : classifier width (0 → headless pooled features).
    width_mult : torchvision's channel multiplier.
    dtype : activation dtype (bfloat16 by default).
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    bn_eps = 1e-3  # torchvision: partial(BatchNorm2d, eps=0.001, momentum=0.01)

    def __init__(self, variant: str = "large", num_classes: int = 1000, *, width_mult: float = 1.0,
                 dtype=torch.bfloat16, device=None):
        if variant not in _V3_VARIANTS:
            raise ValueError(f"variant must be one of {sorted(_V3_VARIANTS)}, got {variant!r}")
        self.variant = variant
        self.num_classes = num_classes
        self.width_mult = width_mult
        self.dtype = dtype
        self.device = resolve_device(device)
        rows, hidden = _V3_VARIANTS[variant]
        self.stem_ch = _make_divisible(16 * width_mult)
        self.blocks = [_V3Block(*row, width_mult) for row in rows]
        self.head_ch = 6 * self.blocks[-1].c_out  # lastconv_output_channels
        self.hidden_ch = _make_divisible(hidden * width_mult)  # torchvision adjust_channels(last_channel)
        self.num_features = self.head_ch
        self.module_names = tuple(self._enumerate_module_names())

    def _enumerate_module_names(self):
        names = ["features"] + cna_names("features.0")
        for bi, blk in enumerate(self.blocks, start=1):
            base = f"features.{bi}"
            names += [base, f"{base}.block"]
            if blk.has_expand:
                names += cna_names(f"{base}.block.0")
            names += cna_names(f"{base}.block.{blk.i_dw}")
            if blk.use_se:
                names += se_names(f"{base}.block.{blk.i_se}")
            names += cna_names(f"{base}.block.{blk.i_proj}", act=False)
        names += cna_names(f"features.{len(self.blocks) + 1}") + ["avgpool"]
        return names + ([f"classifier{s}" for s in ("", ".0", ".1", ".2", ".3")] if self.num_classes else [])

    def _param_specs(self):
        specs = conv_bn_specs("features.0", 3, 3, self.stem_ch)
        for bi, blk in enumerate(self.blocks, start=1):
            base = f"features.{bi}.block"
            if blk.has_expand:
                specs += conv_bn_specs(f"{base}.0", 1, blk.c_in, blk.c_mid)
            specs += conv_bn_specs(f"{base}.{blk.i_dw}", blk.kernel, blk.c_mid, blk.c_mid, kind="dwconv")
            if blk.use_se:
                specs += se_specs(f"{base}.{blk.i_se}", blk.c_mid, blk.c_se)
            specs += conv_bn_specs(f"{base}.{blk.i_proj}", 1, blk.c_mid, blk.c_out)
        specs += conv_bn_specs(f"features.{len(self.blocks) + 1}", 1, self.blocks[-1].c_out, self.head_ch)
        if self.num_classes:
            specs += [("classifier.0.weight", (self.head_ch, self.hidden_ch), "fc"),
                      ("classifier.0.bias", (self.hidden_ch,), "zeros"),
                      ("classifier.3.weight", (self.hidden_ch, self.num_classes), "fc"),
                      ("classifier.3.bias", (self.num_classes,), "zeros")]
        return specs

    def _bneck(self, params, x, base, blk: _V3Block, tap):
        act = hardswish if blk.act == "HS" else torch.relu
        h = x
        if blk.has_expand:
            h = self._cna(params, h, f"{base}.block.0", tap, act=act)
        h = self._cna(params, h, f"{base}.block.{blk.i_dw}", tap, stride=blk.stride, kernel=blk.kernel,
                      groups=blk.c_mid, act=act)
        if blk.use_se:
            h = self._squeeze_excite(params, h, f"{base}.block.{blk.i_se}", tap, squeeze=torch.relu,
                                     gate=F.hardsigmoid)
        h = tap(f"{base}.block", self._cna(params, h, f"{base}.block.{blk.i_proj}", tap))
        return tap(base, residual_add(x, h) if blk.residual else h)

    def _forward(self, params, x, tap):
        x = self._cna(params, x, "features.0", tap, stride=2, kernel=3, act=hardswish)
        for bi, blk in enumerate(self.blocks, start=1):
            x = self._bneck(params, x, f"features.{bi}", blk, tap)
        x = self._cna(params, x, f"features.{len(self.blocks) + 1}", tap, act=hardswish)
        x = tap("features", x)
        x = tap("avgpool", global_avg_pool(x)).flatten(1)
        if self.num_classes:
            x = tap("classifier.0", linear(x, params["classifier.0.weight"], params["classifier.0.bias"]))
            x = tap("classifier.2", tap("classifier.1", hardswish(x)))  # .2 = Dropout: identity at inference
            x = tap("classifier", tap("classifier.3", linear(x, params["classifier.3.weight"],
                                                              params["classifier.3.bias"])))
        return x

    def __repr__(self):
        w = f", width_mult={self.width_mult}" if self.width_mult != 1.0 else ""
        return f"MobileNetV3(variant={self.variant!r}, num_classes={self.num_classes}{w})"
