"""Functional torchvision-compatible AlexNet and SqueezeNet with named taps.

Counterpart of ``semanticlens_tpu.models.classic``, with the module and
parameter names of torchvision's ``alexnet`` / ``squeezenet1_0`` /
``squeezenet1_1``, so their state dicts load as they are:

- AlexNet's 11×11/s4 stem pads by 2 and its pools are not ``ceil_mode``;
  the 6×6 adaptive pool is the JAX package's (identity at 6×6, an exact
  mean when the map is a multiple of 6, a ``ValueError`` otherwise); the
  classifier's flatten is torch's own, channel-major over NCHW;
- SqueezeNet's stem conv has no padding (7×7/s2 in 1.0, 3×3/s2 in 1.1),
  every max pool is 3×3/s2 with ``ceil_mode=True`` (torch's semantics,
  which the JAX package emulates with extra −inf padding); Fire modules
  concatenate ``expand1x1`` then ``expand3x3``; the head is a 1×1 conv,
  a ReLU and a mean, tapped before the flatten as (B, 1, 1, n);
- every conv carries a bias; dropout is the identity at inference.
"""

from __future__ import annotations

import math

import torch

from semanticlens_tpu_torch.models.layers import conv2d, linear, max_pool
from semanticlens_tpu_torch.models.zoo import ZooModel
from semanticlens_tpu_torch.utils.device import resolve_device

# AlexNet features plan: (index, kind, (kernel, stride, pad, c_in, c_out) for convs)
_ALEX_FEATURES = (
    (0, "conv", (11, 4, 2, 3, 64)),
    (1, "relu", None),
    (2, "pool", None),
    (3, "conv", (5, 1, 2, 64, 192)),
    (4, "relu", None),
    (5, "pool", None),
    (6, "conv", (3, 1, 1, 192, 384)),
    (7, "relu", None),
    (8, "conv", (3, 1, 1, 384, 256)),
    (9, "relu", None),
    (10, "conv", (3, 1, 1, 256, 256)),
    (11, "relu", None),
    (12, "pool", None),
)

# SqueezeNet plans: (index, "conv", (k, s, c_in, c_out)) | "relu" | "pool" | ("fire", (c_in, squeeze, e1, e3))
_SQUEEZE_V10 = (
    (0, "conv", (7, 2, 3, 96)),
    (1, "relu", None),
    (2, "pool", None),
    (3, "fire", (96, 16, 64, 64)),
    (4, "fire", (128, 16, 64, 64)),
    (5, "fire", (128, 32, 128, 128)),
    (6, "pool", None),
    (7, "fire", (256, 32, 128, 128)),
    (8, "fire", (256, 48, 192, 192)),
    (9, "fire", (384, 48, 192, 192)),
    (10, "fire", (384, 64, 256, 256)),
    (11, "pool", None),
    (12, "fire", (512, 64, 256, 256)),
)
_SQUEEZE_V11 = (
    (0, "conv", (3, 2, 3, 64)),
    (1, "relu", None),
    (2, "pool", None),
    (3, "fire", (64, 16, 64, 64)),
    (4, "fire", (128, 16, 64, 64)),
    (5, "pool", None),
    (6, "fire", (128, 32, 128, 128)),
    (7, "fire", (256, 32, 128, 128)),
    (8, "pool", None),
    (9, "fire", (256, 48, 192, 192)),
    (10, "fire", (384, 48, 192, 192)),
    (11, "fire", (384, 64, 256, 256)),
    (12, "fire", (512, 64, 256, 256)),
)
_FIRE_PARTS = ("squeeze", "squeeze_activation", "expand1x1", "expand1x1_activation", "expand3x3",
               "expand3x3_activation")


class _Classic(ZooModel):
    """What both families share: the JAX package's draw (kaiming fan-out convs, normal(0.01) linears)."""

    def _draw(self, name, shape, kind):
        if kind == "conv":
            return "normal", math.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
        if kind == "fc":
            return "normal", 0.01
        return "const", 0.0


class AlexNet(_Classic):
    """AlexNet with torchvision-compatible names.

    Parameters
    ----------
    num_classes : classifier width (0 → headless: the 9216-d flattened pool).
    dtype : activation dtype (bfloat16 by default).
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    def __init__(self, num_classes: int = 1000, *, dtype=torch.bfloat16, device=None):
        self.num_classes = num_classes
        self.dtype = dtype
        self.device = resolve_device(device)
        self.num_features = 256 * 6 * 6
        names = ["features"] + [f"features.{i}" for i, _, _ in _ALEX_FEATURES] + ["avgpool"]
        if num_classes:
            names += ["classifier"] + [f"classifier.{i}" for i in range(7)]
        self.module_names = tuple(names)

    def _param_specs(self):
        specs = []
        for i, kind, args in _ALEX_FEATURES:
            if kind == "conv":
                k, _s, _p, cin, cout = args
                specs += [(f"features.{i}.weight", (k, k, cin, cout), "conv"), (f"features.{i}.bias", (cout,), "zeros")]
        if self.num_classes:
            specs += [
                ("classifier.1.weight", (9216, 4096), "fc"),
                ("classifier.1.bias", (4096,), "zeros"),
                ("classifier.4.weight", (4096, 4096), "fc"),
                ("classifier.4.bias", (4096,), "zeros"),
                ("classifier.6.weight", (4096, self.num_classes), "fc"),
                ("classifier.6.bias", (self.num_classes,), "zeros"),
            ]
        return specs

    def _forward(self, params, x, tap):
        for i, kind, args in _ALEX_FEATURES:
            if kind == "conv":
                k, s, p, _cin, _cout = args
                x = conv2d(x, params[f"features.{i}.weight"], params[f"features.{i}.bias"], stride=s, padding=p)
            elif kind == "relu":
                x = torch.relu(x)
            else:
                x = max_pool(x, window=3, stride=2, padding=0)
            x = tap(f"features.{i}", x)
        x = tap("features", x)

        b, c, h, w = x.shape
        if (h, w) != (6, 6):  # AdaptiveAvgPool2d((6, 6)) where its windows are exact
            if h % 6 or w % 6:
                raise ValueError(f"AlexNet input must pool to 6x6; got feature map {h}x{w}")
            x = torch.mean(x.reshape(b, c, 6, h // 6, 6, w // 6), dim=(3, 5))
        x = tap("avgpool", x).flatten(1)  # torch's channel-major flatten
        if not self.num_classes:
            return x
        x = tap("classifier.0", x)  # Dropout: identity at inference
        x = tap("classifier.1", linear(x, params["classifier.1.weight"], params["classifier.1.bias"]))
        x = tap("classifier.3", tap("classifier.2", torch.relu(x)))  # .3 = Dropout
        x = tap("classifier.4", linear(x, params["classifier.4.weight"], params["classifier.4.bias"]))
        x = tap("classifier.5", torch.relu(x))
        x = tap("classifier.6", linear(x, params["classifier.6.weight"], params["classifier.6.bias"]))
        return tap("classifier", x)

    def __repr__(self):
        return f"AlexNet(num_classes={self.num_classes})"


class SqueezeNet(_Classic):
    """SqueezeNet 1.0 / 1.1 with torchvision-compatible names.

    Parameters
    ----------
    version : "1_0" | "1_1".
    num_classes : classifier 1×1-conv width (0 → headless: the pooled 512-d features).
    dtype : activation dtype (bfloat16 by default).
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    def __init__(self, version: str = "1_0", num_classes: int = 1000, *, dtype=torch.bfloat16, device=None):
        if version not in ("1_0", "1_1"):
            raise ValueError(f"version must be '1_0' or '1_1', got {version!r}")
        self.version = version
        self.num_classes = num_classes
        self.dtype = dtype
        self.device = resolve_device(device)
        self.plan = _SQUEEZE_V10 if version == "1_0" else _SQUEEZE_V11
        self.num_features = 512
        names = ["features"]
        for i, kind, _ in self.plan:
            names.append(f"features.{i}")
            if kind == "fire":
                names += [f"features.{i}.{p}" for p in _FIRE_PARTS]
        if num_classes:
            names += ["classifier"] + [f"classifier.{i}" for i in range(4)]
        self.module_names = tuple(names)

    def _param_specs(self):
        specs = []
        for i, kind, args in self.plan:
            if kind == "conv":
                k, _s, cin, cout = args
                specs += [(f"features.{i}.weight", (k, k, cin, cout), "conv"), (f"features.{i}.bias", (cout,), "zeros")]
            elif kind == "fire":
                cin, sq, e1, e3 = args
                specs += [
                    (f"features.{i}.squeeze.weight", (1, 1, cin, sq), "conv"),
                    (f"features.{i}.squeeze.bias", (sq,), "zeros"),
                    (f"features.{i}.expand1x1.weight", (1, 1, sq, e1), "conv"),
                    (f"features.{i}.expand1x1.bias", (e1,), "zeros"),
                    (f"features.{i}.expand3x3.weight", (3, 3, sq, e3), "conv"),
                    (f"features.{i}.expand3x3.bias", (e3,), "zeros"),
                ]
        if self.num_classes:
            specs += [("classifier.1.weight", (1, 1, 512, self.num_classes), "conv"),
                      ("classifier.1.bias", (self.num_classes,), "zeros")]
        return specs

    def _fire(self, params, x, base, tap):
        s = tap(f"{base}.squeeze", conv2d(x, params[f"{base}.squeeze.weight"], params[f"{base}.squeeze.bias"]))
        s = tap(f"{base}.squeeze_activation", torch.relu(s))
        e1 = tap(f"{base}.expand1x1", conv2d(s, params[f"{base}.expand1x1.weight"], params[f"{base}.expand1x1.bias"]))
        e1 = tap(f"{base}.expand1x1_activation", torch.relu(e1))
        e3 = tap(f"{base}.expand3x3",
                 conv2d(s, params[f"{base}.expand3x3.weight"], params[f"{base}.expand3x3.bias"], padding=1))
        e3 = tap(f"{base}.expand3x3_activation", torch.relu(e3))
        return tap(base, torch.cat([e1, e3], 1))

    def _forward(self, params, x, tap):
        for i, kind, args in self.plan:
            if kind == "fire":
                x = self._fire(params, x, f"features.{i}", tap)
                continue
            if kind == "conv":
                _k, s, _cin, _cout = args
                x = conv2d(x, params[f"features.{i}.weight"], params[f"features.{i}.bias"], stride=s)  # no padding
            elif kind == "relu":
                x = torch.relu(x)
            else:
                x = max_pool(x, window=3, stride=2, padding=0, ceil_mode=True)
            x = tap(f"features.{i}", x)
        x = tap("features", x)
        if not self.num_classes:
            return torch.mean(x, dim=(2, 3))
        x = tap("classifier.0", x)  # Dropout: identity at inference
        x = tap("classifier.1", conv2d(x, params["classifier.1.weight"], params["classifier.1.bias"]))
        x = tap("classifier.2", torch.relu(x))
        x = tap("classifier.3", torch.mean(x, dim=(2, 3), keepdim=True))
        return tap("classifier", x).flatten(1)  # tapped before the flatten, (B, 1, 1, n)

    def __repr__(self):
        return f"SqueezeNet(version={self.version!r}, num_classes={self.num_classes})"
