"""Functional torchvision-compatible VGG with named activation taps.

Counterpart of ``semanticlens_tpu.models.vgg``: VGG-11/13/16/19, plain and
batch-norm (``vgg*_bn``), with torchvision's module and parameter names
(``features.{i}`` Sequential indices, ``classifier.{0,3,6}`` linears), so a
torchvision state dict loads as it is. The flatten before the classifier is
torch's own, channel-major over NCHW. The 7×7 "adaptive" pool is the JAX
package's: identity at 7×7, an exact mean when the feature map is a multiple
of 7, a ``ValueError`` otherwise (``F.adaptive_avg_pool2d``'s windows differ
for other sizes). Dropout is the identity at inference.
"""

from __future__ import annotations

import math

import torch

from semanticlens_tpu_torch.models.layers import conv2d, linear, max_pool
from semanticlens_tpu_torch.models.zoo import ZooModel
from semanticlens_tpu_torch.utils.device import resolve_device

# torchvision cfgs: number = conv output channels, "M" = 2×2 maxpool.
_CFGS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    13: (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"),
    19: (
        64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512, 512, 512, 512, "M",
    ),
}


class VGG(ZooModel):
    """VGG-11/13/16/19 with torchvision-compatible names.

    Parameters
    ----------
    depth : one of 11, 13, 16, 19.
    num_classes : classifier width (0 → headless: returns the 4096-d
        penultimate activation, after ``classifier.4``'s ReLU).
    batch_norm : the ``vgg*_bn`` variant (conv → BN → ReLU triplets).
    dtype : activation dtype (bfloat16 by default).
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    def __init__(self, depth: int = 16, num_classes: int = 1000, *, batch_norm: bool = False,
                 dtype=torch.bfloat16, device=None):
        if depth not in _CFGS:
            raise ValueError(f"depth must be one of {sorted(_CFGS)}, got {depth}")
        self.depth = depth
        self.num_classes = num_classes
        self.bn = batch_norm
        self.dtype = dtype
        self.device = resolve_device(device)
        # (feature_index, kind, channels) walk of the torchvision Sequential.
        self._plan: list[tuple[int, str, int]] = []
        idx, cin = 0, 3
        for item in _CFGS[depth]:
            if item == "M":
                self._plan.append((idx, "pool", cin))
                idx += 1
                continue
            self._plan.append((idx, "conv", item))
            idx += 1
            if batch_norm:
                self._plan.append((idx, "bn", item))
                idx += 1
            self._plan.append((idx, "relu", item))
            idx += 1
            cin = item
        self.module_names = tuple(self._enumerate_module_names())

    def _enumerate_module_names(self):
        names = ["features"] + [f"features.{i}" for i, _, _ in self._plan]
        # classifier.2/.5 are torchvision's Dropout modules: identity at inference, still hook targets.
        names += ["avgpool", "classifier"] + [f"classifier.{i}" for i in range(6)]
        return names + (["classifier.6"] if self.num_classes else [])

    def _param_specs(self):
        specs, cin = [], 3
        for i, kind, ch in self._plan:
            if kind == "conv":
                specs += [(f"features.{i}.weight", (3, 3, cin, ch), "conv"), (f"features.{i}.bias", (ch,), "zeros")]
                cin = ch
            elif kind == "bn":
                specs += [(f"features.{i}.weight", (ch,), "ones"), (f"features.{i}.bias", (ch,), "zeros"),
                          (f"features.{i}.running_mean", (ch,), "zeros"),
                          (f"features.{i}.running_var", (ch,), "ones")]
        specs += [
            ("classifier.0.weight", (512 * 7 * 7, 4096), "fc"),
            ("classifier.0.bias", (4096,), "zeros"),
            ("classifier.3.weight", (4096, 4096), "fc"),
            ("classifier.3.bias", (4096,), "zeros"),
        ]
        if self.num_classes:
            specs += [("classifier.6.weight", (4096, self.num_classes), "fc"),
                      ("classifier.6.bias", (self.num_classes,), "zeros")]
        return specs

    def _draw(self, name, shape, kind):
        """Kaiming-normal convs (fan_in) and normal(0.01) linears: the JAX package's (torchvision's) scheme."""
        if kind == "conv":
            return "normal", math.sqrt(2.0 / (shape[0] * shape[1] * shape[2]))
        if kind == "fc":
            return "normal", 0.01
        return "const", 1.0 if kind == "ones" else 0.0

    def _forward(self, params, x, tap):
        for i, kind, _ in self._plan:
            p = f"features.{i}"
            if kind == "conv":
                x = conv2d(x, params[f"{p}.weight"], params[f"{p}.bias"], padding=1)
            elif kind == "bn":
                x = self._bn(params, p, x)
            elif kind == "relu":
                x = torch.relu(x)
            else:
                x = max_pool(x, window=2, stride=2, padding=0)
            x = tap(p, x)
        x = tap("features", x)

        b, c, h, w = x.shape
        if (h, w) != (7, 7):  # AdaptiveAvgPool2d((7, 7)) where its windows are exact
            if h % 7 or w % 7:
                raise ValueError(f"VGG input must pool to 7x7; got feature map {h}x{w}")
            x = torch.mean(x.reshape(b, c, 7, h // 7, 7, w // 7), dim=(3, 5))
        x = tap("avgpool", x).flatten(1)  # torch's channel-major flatten
        x = tap("classifier.0", linear(x, params["classifier.0.weight"], params["classifier.0.bias"]))
        x = tap("classifier.2", tap("classifier.1", torch.relu(x)))
        x = tap("classifier.3", linear(x, params["classifier.3.weight"], params["classifier.3.bias"]))
        x = tap("classifier.5", tap("classifier.4", torch.relu(x)))
        if self.num_classes:
            x = tap("classifier.6", linear(x, params["classifier.6.weight"], params["classifier.6.bias"]))
        return tap("classifier", x)

    def __repr__(self):
        bn = ", batch_norm=True" if self.bn else ""
        return f"VGG(depth={self.depth}, num_classes={self.num_classes}{bn})"
