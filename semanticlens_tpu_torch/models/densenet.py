"""Functional torchvision-compatible DenseNet with named activation taps.

Counterpart of ``semanticlens_tpu.models.densenet``: DenseNet-121/161/169/201
with torchvision's module and parameter names
(``features.denseblock{i}.denselayer{j}.conv2`` …), so a torchvision state
dict loads as it is. Each dense layer is BN-ReLU-conv pre-activation; its
tap is the ``growth_rate`` new channels, concatenated onto the running
feature map (dim 1 of NCHW) by its block. Every conv is bias-free. The final
ReLU and pool are functional in torchvision, so ``features.norm5`` is the
last conv-path tap.
"""

from __future__ import annotations

import math

import torch

from semanticlens_tpu_torch.models.layers import avg_pool, bn_param_specs, conv2d, global_avg_pool, linear, max_pool
from semanticlens_tpu_torch.models.zoo import ZooModel
from semanticlens_tpu_torch.utils.device import resolve_device

# depth -> (growth_rate, block_config, num_init_features); bn_size is 4 for all.
_CFGS = {
    121: (32, (6, 12, 24, 16), 64),
    161: (48, (6, 12, 36, 24), 96),
    169: (32, (6, 12, 32, 32), 64),
    201: (32, (6, 12, 48, 32), 64),
}
_BN_SIZE = 4


class DenseNet(ZooModel):
    """DenseNet-121/161/169/201 with torchvision-compatible names.

    Parameters
    ----------
    depth : one of 121, 161, 169, 201.
    num_classes : classifier width (0 → headless: returns the pooled
        ``num_features``-d vector after the final functional ReLU).
    dtype : activation dtype (bfloat16 by default).
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    def __init__(self, depth: int = 121, num_classes: int = 1000, *, dtype=torch.bfloat16, device=None):
        if depth not in _CFGS:
            raise ValueError(f"depth must be one of {sorted(_CFGS)}, got {depth}")
        self.depth = depth
        self.num_classes = num_classes
        self.dtype = dtype
        self.device = resolve_device(device)
        self.growth_rate, self.block_config, self.num_init_features = _CFGS[depth]
        self._blocks: list[tuple[int, int, int]] = []  # (block_idx, n_layers, c_in)
        c = self.num_init_features
        for bi, n_layers in enumerate(self.block_config, start=1):
            self._blocks.append((bi, n_layers, c))
            c += n_layers * self.growth_rate
            if bi != len(self.block_config):
                c = c // 2  # a transition halves the channels
        self.num_features = c
        self.module_names = tuple(self._enumerate_module_names())

    def _enumerate_module_names(self):
        names = ["features", "features.conv0", "features.norm0", "features.relu0", "features.pool0"]
        for bi, n_layers, _ in self._blocks:
            names.append(f"features.denseblock{bi}")
            for li in range(1, n_layers + 1):
                base = f"features.denseblock{bi}.denselayer{li}"
                names += [base] + [f"{base}.{m}" for m in ("norm1", "relu1", "conv1", "norm2", "relu2", "conv2")]
            if bi != len(self.block_config):
                t = f"features.transition{bi}"
                names += [t] + [f"{t}.{m}" for m in ("norm", "relu", "conv", "pool")]
        names.append("features.norm5")
        return names + (["classifier"] if self.num_classes else [])

    def _param_specs(self):
        g, bottleneck = self.growth_rate, _BN_SIZE * self.growth_rate
        specs = [("features.conv0.weight", (7, 7, 3, self.num_init_features), "conv")]
        specs += bn_param_specs("features.norm0", self.num_init_features, ones_kind="ones")
        for bi, n_layers, c in self._blocks:
            for li in range(1, n_layers + 1):
                base = f"features.denseblock{bi}.denselayer{li}"
                specs += bn_param_specs(f"{base}.norm1", c, ones_kind="ones")
                specs.append((f"{base}.conv1.weight", (1, 1, c, bottleneck), "conv"))
                specs += bn_param_specs(f"{base}.norm2", bottleneck, ones_kind="ones")
                specs.append((f"{base}.conv2.weight", (3, 3, bottleneck, g), "conv"))
                c += g
            if bi != len(self.block_config):
                t = f"features.transition{bi}"
                specs += bn_param_specs(f"{t}.norm", c, ones_kind="ones")
                specs.append((f"{t}.conv.weight", (1, 1, c, c // 2), "conv"))
        specs += bn_param_specs("features.norm5", self.num_features, ones_kind="ones")
        if self.num_classes:
            specs += [("classifier.weight", (self.num_features, self.num_classes), "fc"),
                      ("classifier.bias", (self.num_classes,), "zeros")]
        return specs

    def _draw(self, name, shape, kind):
        """Kaiming-normal convs (fan_in), uniform ±1/√in classifier, unit BN: torchvision's scheme."""
        if kind == "conv":
            return "normal", math.sqrt(2.0 / (shape[0] * shape[1] * shape[2]))
        if kind == "fc":
            return "uniform", 1.0 / math.sqrt(shape[0])
        return "const", 1.0 if kind == "ones" else 0.0

    def _dense_layer(self, params, x, base, tap):
        """One torchvision ``_DenseLayer``: returns the NEW ``growth_rate`` channels."""
        h = tap(f"{base}.norm1", self._bn(params, f"{base}.norm1", x))
        h = tap(f"{base}.relu1", torch.relu(h))
        h = tap(f"{base}.conv1", conv2d(h, params[f"{base}.conv1.weight"]))
        h = tap(f"{base}.norm2", self._bn(params, f"{base}.norm2", h))
        h = tap(f"{base}.relu2", torch.relu(h))
        h = tap(f"{base}.conv2", conv2d(h, params[f"{base}.conv2.weight"], padding=1))
        return tap(base, h)

    def _forward(self, params, x, tap):
        x = tap("features.conv0", conv2d(x, params["features.conv0.weight"], stride=2, padding=3))
        x = tap("features.norm0", self._bn(params, "features.norm0", x))
        x = tap("features.relu0", torch.relu(x))
        x = tap("features.pool0", max_pool(x, window=3, stride=2, padding=1))
        for bi, n_layers, _ in self._blocks:
            for li in range(1, n_layers + 1):
                x = torch.cat([x, self._dense_layer(params, x, f"features.denseblock{bi}.denselayer{li}", tap)], dim=1)
            x = tap(f"features.denseblock{bi}", x)
            if bi != len(self.block_config):
                t = f"features.transition{bi}"
                x = tap(f"{t}.norm", self._bn(params, f"{t}.norm", x))
                x = tap(f"{t}.relu", torch.relu(x))
                x = tap(f"{t}.conv", conv2d(x, params[f"{t}.conv.weight"]))
                x = tap(t, tap(f"{t}.pool", avg_pool(x, window=2, stride=2, padding=0)))
        x = tap("features.norm5", self._bn(params, "features.norm5", x))
        x = tap("features", x)
        x = global_avg_pool(torch.relu(x)).flatten(1)  # torchvision: functional relu → pool → flatten
        if self.num_classes:
            return tap("classifier", linear(x, params["classifier.weight"], params["classifier.bias"]))
        return x

    def __repr__(self):
        return f"DenseNet(depth={self.depth}, num_classes={self.num_classes})"
