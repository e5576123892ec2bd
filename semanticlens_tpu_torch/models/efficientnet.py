"""Functional torchvision-compatible EfficientNet (B0–B7) and EfficientNetV2 (S/M/L) with named taps.

Counterpart of ``semanticlens_tpu.models.efficientnet``, with torchvision's
module and parameter names (``features.{stage}.{block}.block.{idx}…``, SE
as ``fc1``/``fc2``), so a torchvision state dict loads as it is:

- widths go through torchvision's ``_make_divisible(v, 8)`` and block
  counts through ``ceil(layers * depth_mult)``, the compound-scaling
  arithmetic exactly;
- the SE squeeze width is ``max(1, block_input_channels // 4)``; its 1×1
  convs are (out, in, 1, 1) weights run as linears on the pooled rows, and
  its sigmoid gate goes through ``gate_scale`` (a constant under LRP);
- BN eps is per variant: 1e-5 for B0–B4, 1e-3 for B5–B7 and every V2;
- stochastic depth and dropout are the identity at inference, and stay
  hookable names;
- V2's early stages are Fused-MBConv (one dense k×k expansion conv, no SE).
"""

from __future__ import annotations

import math

import torch

from semanticlens_tpu_torch.models.layers import global_avg_pool, linear, residual_add, silu
from semanticlens_tpu_torch.models.zoo import ZooModel, cna_names, conv_bn_specs, se_names, se_specs
from semanticlens_tpu_torch.utils.device import resolve_device

# Base (B0) stage settings: (expand_ratio, kernel, stride, in_ch, out_ch, layers)
_B0_STAGES = (
    (1, 3, 1, 32, 16, 1),
    (6, 3, 2, 16, 24, 2),
    (6, 5, 2, 24, 40, 2),
    (6, 3, 2, 40, 80, 3),
    (6, 5, 1, 80, 112, 3),
    (6, 5, 2, 112, 192, 4),
    (6, 3, 1, 192, 320, 1),
)

# variant -> (width_mult, depth_mult, bn_eps)
_VARIANTS = {
    "b0": (1.0, 1.0, 1e-5),
    "b1": (1.0, 1.1, 1e-5),
    "b2": (1.1, 1.2, 1e-5),
    "b3": (1.2, 1.4, 1e-5),
    "b4": (1.4, 1.8, 1e-5),
    "b5": (1.6, 2.2, 1e-3),
    "b6": (1.8, 2.6, 1e-3),
    "b7": (2.0, 3.1, 1e-3),
}


def _make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision.models._utils._make_divisible: round to the nearest multiple, at least 0.9·v."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _BlockCfg:
    """One MBConv instance after compound scaling (torchvision ``MBConvConfig``)."""

    fused = False

    def __init__(self, expand, kernel, stride, c_in, c_out):
        self.expand = expand
        self.kernel = kernel
        self.stride = stride
        self.c_in = c_in
        self.c_out = c_out
        self.c_mid = _make_divisible(c_in * expand)
        self.c_se = max(1, c_in // 4)
        self.has_expand = self.c_mid != c_in
        # block.{idx} positions inside the torchvision MBConv Sequential
        self.i_dw = 1 if self.has_expand else 0
        self.i_se = self.i_dw + 1
        self.i_proj = self.i_se + 1
        self.residual = stride == 1 and c_in == c_out


class _FusedBlockCfg:
    """One FusedMBConv instance (torchvision ``FusedMBConvConfig``): a dense k×k expansion, no SE or depthwise."""

    fused = True

    def __init__(self, expand, kernel, stride, c_in, c_out):
        self.expand = expand
        self.kernel = kernel
        self.stride = stride
        self.c_in = c_in
        self.c_out = c_out
        self.c_mid = _make_divisible(c_in * expand)
        self.has_expand = self.c_mid != c_in
        self.residual = stride == 1 and c_in == c_out


class EfficientNet(ZooModel):
    """EfficientNet-B0…B7 with torchvision-compatible names.

    Parameters
    ----------
    variant : "b0" … "b7".
    num_classes : classifier width (0 → headless pooled features).
    dtype : activation dtype (bfloat16 by default).
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    def __init__(self, variant: str = "b0", num_classes: int = 1000, *, dtype=torch.bfloat16, device=None):
        if variant not in _VARIANTS:
            raise ValueError(f"variant must be one of {sorted(_VARIANTS)}, got {variant!r}")
        self.variant = variant
        self.num_classes = num_classes
        self.dtype = dtype
        self.device = resolve_device(device)
        width, depth, self.bn_eps = _VARIANTS[variant]

        def adjust(c):
            return _make_divisible(c * width)

        self.stem_ch = adjust(32)
        self.stages = []
        for expand, kernel, stride, c_in, c_out, layers in _B0_STAGES:
            c_in, c_out = adjust(c_in), adjust(c_out)
            self.stages.append([_BlockCfg(expand, kernel, stride if j == 0 else 1, c_in if j == 0 else c_out, c_out)
                                for j in range(int(math.ceil(layers * depth)))])
        self.head_ch = 4 * self.stages[-1][-1].c_out
        self.num_features = self.head_ch
        self.module_names = tuple(self._enumerate_module_names())

    # ----------------------------------------------------------------- names
    def _block_names(self, base, cfg):
        names = [base, f"{base}.block"]
        if cfg.fused:
            names += cna_names(f"{base}.block.0")
            if cfg.has_expand:
                names += cna_names(f"{base}.block.1", act=False)
        else:
            if cfg.has_expand:
                names += cna_names(f"{base}.block.0")
            names += cna_names(f"{base}.block.{cfg.i_dw}")
            names += se_names(f"{base}.block.{cfg.i_se}")
            names += cna_names(f"{base}.block.{cfg.i_proj}", act=False)
        return names + [f"{base}.stochastic_depth"]

    def _enumerate_module_names(self):
        names = ["features"] + cna_names("features.0")
        for si, blocks in enumerate(self.stages, start=1):
            names.append(f"features.{si}")
            for bi, cfg in enumerate(blocks):
                names += self._block_names(f"features.{si}.{bi}", cfg)
        names += cna_names(f"features.{len(self.stages) + 1}") + ["avgpool"]
        return names + (["classifier", "classifier.0", "classifier.1"] if self.num_classes else [])

    # ----------------------------------------------------------------- specs
    def _param_specs(self):
        specs = conv_bn_specs("features.0", 3, 3, self.stem_ch)
        for si, blocks in enumerate(self.stages, start=1):
            for bi, cfg in enumerate(blocks):
                base, k = f"features.{si}.{bi}.block", cfg.kernel
                if cfg.fused:
                    if cfg.has_expand:
                        specs += conv_bn_specs(f"{base}.0", k, cfg.c_in, cfg.c_mid)
                        specs += conv_bn_specs(f"{base}.1", 1, cfg.c_mid, cfg.c_out)
                    else:
                        specs += conv_bn_specs(f"{base}.0", k, cfg.c_in, cfg.c_out)
                    continue
                if cfg.has_expand:
                    specs += conv_bn_specs(f"{base}.0", 1, cfg.c_in, cfg.c_mid)
                specs += conv_bn_specs(f"{base}.{cfg.i_dw}", k, cfg.c_mid, cfg.c_mid, kind="dwconv")
                specs += se_specs(f"{base}.{cfg.i_se}", cfg.c_mid, cfg.c_se)
                specs += conv_bn_specs(f"{base}.{cfg.i_proj}", 1, cfg.c_mid, cfg.c_out)
        specs += conv_bn_specs(f"features.{len(self.stages) + 1}", 1, self.stages[-1][-1].c_out, self.head_ch)
        if self.num_classes:
            specs += [("classifier.1.weight", (self.head_ch, self.num_classes), "fc"),
                      ("classifier.1.bias", (self.num_classes,), "zeros")]
        return specs

    def _draw(self, name, shape, kind):
        """Kaiming-normal fan-out for every conv (the SE 1×1s' fan-out is their out-channels), unit BN, and
        uniform ±1/√out for the classifier: torchvision's scheme."""
        if kind in ("conv", "dwconv"):
            return "normal", math.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
        if kind == "se_fc":
            return "normal", math.sqrt(2.0 / shape[1])
        if kind == "fc":
            return "uniform", 1.0 / math.sqrt(shape[1])
        return "const", 1.0 if kind == "bn_w" else 0.0

    # ----------------------------------------------------------------- apply
    def _mbconv(self, params, x, base, cfg: _BlockCfg, tap):
        h = x
        if cfg.has_expand:
            h = self._cna(params, h, f"{base}.block.0", tap, act=silu)
        h = self._cna(params, h, f"{base}.block.{cfg.i_dw}", tap, stride=cfg.stride, kernel=cfg.kernel,
                      groups=cfg.c_mid, act=silu)
        h = self._squeeze_excite(params, h, f"{base}.block.{cfg.i_se}", tap)
        h = self._cna(params, h, f"{base}.block.{cfg.i_proj}", tap)
        h = tap(f"{base}.stochastic_depth", tap(f"{base}.block", h))  # stochastic depth: identity at inference
        return tap(base, residual_add(x, h) if cfg.residual else h)

    def _fused_mbconv(self, params, x, base, cfg: _FusedBlockCfg, tap):
        h = self._cna(params, x, f"{base}.block.0", tap, stride=cfg.stride, kernel=cfg.kernel, act=silu)
        if cfg.has_expand:
            h = self._cna(params, h, f"{base}.block.1", tap)
        h = tap(f"{base}.stochastic_depth", tap(f"{base}.block", h))
        return tap(base, residual_add(x, h) if cfg.residual else h)

    def _forward(self, params, x, tap):
        x = self._cna(params, x, "features.0", tap, stride=2, kernel=3, act=silu)
        for si, blocks in enumerate(self.stages, start=1):
            for bi, cfg in enumerate(blocks):
                block = self._fused_mbconv if cfg.fused else self._mbconv
                x = block(params, x, f"features.{si}.{bi}", cfg, tap)
            x = tap(f"features.{si}", x)
        x = self._cna(params, x, f"features.{len(self.stages) + 1}", tap, act=silu)
        x = tap("features", x)
        x = tap("classifier.0", tap("avgpool", global_avg_pool(x)).flatten(1))  # dropout: identity at inference
        if self.num_classes:
            x = tap("classifier", tap("classifier.1", linear(x, params["classifier.1.weight"],
                                                              params["classifier.1.bias"])))
        return x

    def __repr__(self):
        return f"EfficientNet(variant={self.variant!r}, num_classes={self.num_classes})"


# EfficientNetV2 stage rows: (fused, expand, kernel, stride, c_in, c_out, layers)
_V2_CONFS = {
    "v2_s": (24, (
        (True, 1, 3, 1, 24, 24, 2),
        (True, 4, 3, 2, 24, 48, 4),
        (True, 4, 3, 2, 48, 64, 4),
        (False, 4, 3, 2, 64, 128, 6),
        (False, 6, 3, 1, 128, 160, 9),
        (False, 6, 3, 2, 160, 256, 15),
    )),
    "v2_m": (24, (
        (True, 1, 3, 1, 24, 24, 3),
        (True, 4, 3, 2, 24, 48, 5),
        (True, 4, 3, 2, 48, 80, 5),
        (False, 4, 3, 2, 80, 160, 7),
        (False, 6, 3, 1, 160, 176, 14),
        (False, 6, 3, 2, 176, 304, 18),
        (False, 6, 3, 1, 304, 512, 5),
    )),
    "v2_l": (32, (
        (True, 1, 3, 1, 32, 32, 4),
        (True, 4, 3, 2, 32, 64, 7),
        (True, 4, 3, 2, 64, 96, 7),
        (False, 4, 3, 2, 96, 192, 10),
        (False, 6, 3, 1, 192, 224, 19),
        (False, 6, 3, 2, 224, 384, 25),
        (False, 6, 3, 1, 384, 640, 7),
    )),
}


class EfficientNetV2(EfficientNet):
    """EfficientNetV2-S/M/L with torchvision-compatible names.

    Fused-MBConv early stages and MBConv late ones with explicit per-stage
    channels (no compound scaling), BN eps 1e-3, a fixed 1280-d head:
    torchvision's ``efficientnet_v2_{s,m,l}``. Taps, LRP rules and loading
    are :class:`EfficientNet`'s.
    """

    def __init__(self, variant: str = "v2_s", num_classes: int = 1000, *, dtype=torch.bfloat16, device=None):
        if variant not in _V2_CONFS:
            raise ValueError(f"variant must be one of {sorted(_V2_CONFS)}, got {variant!r}")
        self.variant = variant
        self.num_classes = num_classes
        self.dtype = dtype
        self.device = resolve_device(device)
        self.bn_eps = 1e-3
        self.stem_ch, rows = _V2_CONFS[variant]
        self.stages = []
        for fused, expand, kernel, stride, c_in, c_out, layers in rows:
            cfg = _FusedBlockCfg if fused else _BlockCfg
            self.stages.append([cfg(expand, kernel, stride if j == 0 else 1, c_in if j == 0 else c_out, c_out)
                                for j in range(layers)])
        self.head_ch = 1280  # torchvision: the last channel is fixed for V2
        self.num_features = self.head_ch
        self.module_names = tuple(self._enumerate_module_names())

    def __repr__(self):
        return f"EfficientNetV2(variant={self.variant!r}, num_classes={self.num_classes})"
