"""Functional torchvision-compatible ResNets with named activation taps.

Counterpart of ``semanticlens_tpu.models.resnet`` for the torchvision
ResNet-v1.5 family (variant ``""``, ``groups=1``): ResNet-18/34/50/101/152
with torchvision module and parameter names, so torchvision state dicts load
as they are. The forward runs NCHW in channels_last memory (cuDNN's
preferred layout); ``apply`` takes and returns the JAX package's layouts:
(B, H, W, 3) input, (B, H, W, C) conv taps. Inference-mode BN. The residual joins go through
``layers.residual_add``, which is ``out + identity`` outside an LRP
composite and splits relevance proportionally inside one.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch

from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch.models.base import SubjectModel, TapCollector
from semanticlens_tpu_torch.models.layers import (
    batch_norm,
    conv2d,
    global_avg_pool,
    linear,
    max_pool,
    residual_add,
)
from semanticlens_tpu_torch.utils.device import resolve_device

_STAGE_BLOCKS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
_BOTTLENECK = {50, 101, 152}


def _conv_shape(out_ch, in_ch, k):
    return (k, k, in_ch, out_ch)  # HWIO: the JAX package's interchange layout


def _bn_specs(prefix, ch):
    return [
        (f"{prefix}.weight", (ch,), "bn_scale"),
        (f"{prefix}.bias", (ch,), "bias"),
        (f"{prefix}.running_mean", (ch,), "bias"),
        (f"{prefix}.running_var", (ch,), "bn_scale"),
    ]


class ResNet(SubjectModel):
    """ResNet-18/34/50/101/152 with torch-compatible names.

    Parameters
    ----------
    depth : one of 18, 34, 50, 101, 152.
    num_classes : classifier width.
    dtype : activation dtype (bfloat16 by default).
    device : where parameters live and the forward runs; ``None`` → the
        CUDA card (raises without one); pass ``"cpu"`` for the CPU.
    """

    def __init__(self, depth: int = 18, num_classes: int = 1000, dtype=torch.bfloat16, device=None):
        if depth not in _STAGE_BLOCKS:
            raise ValueError(f"Unsupported ResNet depth {depth}")
        self.depth = depth
        self.num_classes = num_classes
        self.dtype = dtype
        self.device = resolve_device(device)
        self.bottleneck = depth in _BOTTLENECK
        self.expansion = 4 if self.bottleneck else 1
        self.stage_blocks = _STAGE_BLOCKS[depth]
        self.module_names = tuple(self._enumerate_module_names())

    # ------------------------------------------------------------------ names
    def _enumerate_module_names(self):
        names = ["conv1", "bn1", "relu", "maxpool"]
        convs = ("conv1", "bn1", "conv2", "bn2", "conv3", "bn3") if self.bottleneck else (
            "conv1", "bn1", "conv2", "bn2")
        in_ch = 64
        for stage, n_blocks in enumerate(self.stage_blocks, start=1):
            out_ch = 64 * (2 ** (stage - 1)) * self.expansion
            names.append(f"layer{stage}")
            for b in range(n_blocks):
                prefix = f"layer{stage}.{b}"
                names += [prefix] + [f"{prefix}.{n}" for n in convs] + [f"{prefix}.relu"]
                if b == 0 and (stage > 1 or in_ch != out_ch):
                    names += [f"{prefix}.downsample", f"{prefix}.downsample.0",
                              f"{prefix}.downsample.1"]
            in_ch = out_ch
        return names + ["avgpool", "fc"]

    # ------------------------------------------------------------------ params
    def _param_specs(self):
        """(name, shape, kind) for every tensor, shapes in the JAX layout."""
        specs = [("conv1.weight", _conv_shape(64, 3, 7), "conv")] + _bn_specs("bn1", 64)
        in_ch = 64
        for stage, n_blocks in enumerate(self.stage_blocks, start=1):
            width = 64 * (2 ** (stage - 1))
            out_ch = width * self.expansion
            for b in range(n_blocks):
                p = f"layer{stage}.{b}"
                if self.bottleneck:
                    specs += [(f"{p}.conv1.weight", _conv_shape(width, in_ch, 1), "conv")]
                    specs += _bn_specs(f"{p}.bn1", width)
                    specs += [(f"{p}.conv2.weight", _conv_shape(width, width, 3), "conv")]
                    specs += _bn_specs(f"{p}.bn2", width)
                    specs += [(f"{p}.conv3.weight", _conv_shape(out_ch, width, 1), "conv")]
                    specs += _bn_specs(f"{p}.bn3", out_ch)
                else:
                    specs += [(f"{p}.conv1.weight", _conv_shape(width, in_ch, 3), "conv")]
                    specs += _bn_specs(f"{p}.bn1", width)
                    specs += [(f"{p}.conv2.weight", _conv_shape(width, width, 3), "conv")]
                    specs += _bn_specs(f"{p}.bn2", width)
                if b == 0 and (stage > 1 or in_ch != out_ch):
                    specs += [(f"{p}.downsample.0.weight", _conv_shape(out_ch, in_ch, 1), "conv")]
                    specs += _bn_specs(f"{p}.downsample.1", out_ch)
                in_ch = out_ch
        specs += [
            ("fc.weight", (512 * self.expansion, self.num_classes), "linear"),
            ("fc.bias", (self.num_classes,), "bias"),
        ]
        return specs

    def init_jax_layout(self, seed: int = 0) -> dict[str, np.ndarray]:
        """Random float32 numpy weights in the JAX package's layout.

        Kaiming-normal convs (fan_out, torchvision's default), uniform fc,
        unit BN — the JAX package's scheme, drawn from ``np.random`` with
        ``seed`` (the streams differ from ``jax.random``'s).
        """
        rng = np.random.default_rng(seed)
        params = {}
        for name, shape, kind in self._param_specs():
            if kind == "conv":
                fan_out = shape[0] * shape[1] * shape[3]
                params[name] = (rng.standard_normal(shape, np.float32)
                                * np.float32(math.sqrt(2.0 / fan_out)))
            elif kind == "linear":
                bound = 1.0 / math.sqrt(shape[0])
                params[name] = rng.uniform(-bound, bound, shape).astype(np.float32)
            elif kind == "bn_scale":
                params[name] = np.ones(shape, np.float32)
            else:
                params[name] = np.zeros(shape, np.float32)
        return params

    def init(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Random weights from ``seed``, placed on the model's device."""
        return self.load_jax_params(self.init_jax_layout(seed))

    def load_jax_params(self, params: Mapping) -> dict[str, torch.Tensor]:
        """Weights in the JAX package's layout → the port's, placed for the forward."""
        return self.load_torch_state_dict(convert.resnet_params_from_jax(params))

    def load_torch_state_dict(self, state_dict: Mapping) -> dict[str, torch.Tensor]:
        """A torchvision ResNet state dict, placed for the forward.

        Conv and fc weights move to the compute dtype (the forward would cast
        them on every call otherwise), convs in channels_last; BN tensors stay
        float32, since BN folds its statistics in float32.
        """
        out = {}
        for name, shape, kind in self._param_specs():
            t = torch.as_tensor(state_dict[name])
            if kind == "conv":
                expected = (shape[3], shape[2], shape[0], shape[1])
                t = t.to(self.device, self.dtype).contiguous(memory_format=torch.channels_last)
            else:
                expected = shape[::-1] if name == "fc.weight" else shape
                t = t.to(self.device, self.dtype if kind == "linear" else torch.float32)
            if tuple(t.shape) != tuple(expected):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != expected {expected}")
            out[name] = t
        return out

    # ------------------------------------------------------------------ apply
    def _bn(self, params, prefix, x):
        return batch_norm(x, params[f"{prefix}.weight"], params[f"{prefix}.bias"],
                          params[f"{prefix}.running_mean"], params[f"{prefix}.running_var"])

    def _downsample(self, params, prefix, x, stride, tap):
        h = tap(f"{prefix}.downsample.0",
                conv2d(x, params[f"{prefix}.downsample.0.weight"], stride=stride))
        h = tap(f"{prefix}.downsample.1", self._bn(params, f"{prefix}.downsample.1", h))
        return tap(f"{prefix}.downsample", h)

    def _basic_block(self, params, prefix, x, stride, tap):
        identity = x
        out = tap(f"{prefix}.conv1", conv2d(x, params[f"{prefix}.conv1.weight"], stride=stride, padding=1))
        out = torch.relu(tap(f"{prefix}.bn1", self._bn(params, f"{prefix}.bn1", out)))
        out = tap(f"{prefix}.conv2", conv2d(out, params[f"{prefix}.conv2.weight"], padding=1))
        out = tap(f"{prefix}.bn2", self._bn(params, f"{prefix}.bn2", out))
        if f"{prefix}.downsample.0.weight" in params:
            identity = self._downsample(params, prefix, x, stride, tap)
        out = tap(f"{prefix}.relu", torch.relu(residual_add(out, identity)))
        return tap(prefix, out)

    def _bottleneck_block(self, params, prefix, x, stride, tap):
        identity = x
        out = tap(f"{prefix}.conv1", conv2d(x, params[f"{prefix}.conv1.weight"]))
        out = torch.relu(tap(f"{prefix}.bn1", self._bn(params, f"{prefix}.bn1", out)))
        out = tap(f"{prefix}.conv2",
                  conv2d(out, params[f"{prefix}.conv2.weight"], stride=stride, padding=1))
        out = torch.relu(tap(f"{prefix}.bn2", self._bn(params, f"{prefix}.bn2", out)))
        out = tap(f"{prefix}.conv3", conv2d(out, params[f"{prefix}.conv3.weight"]))
        out = tap(f"{prefix}.bn3", self._bn(params, f"{prefix}.bn3", out))
        if f"{prefix}.downsample.0.weight" in params:
            identity = self._downsample(params, prefix, x, stride, tap)
        out = tap(f"{prefix}.relu", torch.relu(residual_add(out, identity)))
        return tap(prefix, out)

    def apply(self, params: Mapping, x, tap_names: Sequence[str] = ()):
        """Forward pass. x: (B, H, W, 3) float. Returns (logits, taps), taps NHWC."""
        tap = TapCollector(tap_names, channels_first=True)
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # channels_last NCHW for NHWC-contiguous x
        x = tap("conv1", conv2d(x, params["conv1.weight"], stride=2, padding=3))
        x = tap("bn1", self._bn(params, "bn1", x))
        x = tap("relu", torch.relu(x))
        x = tap("maxpool", max_pool(x, window=3, stride=2, padding=1))
        block_fn = self._bottleneck_block if self.bottleneck else self._basic_block
        for stage, n_blocks in enumerate(self.stage_blocks, start=1):
            for b in range(n_blocks):
                stride = 2 if (stage > 1 and b == 0) else 1
                x = block_fn(params, f"layer{stage}.{b}", x, stride, tap)
            x = tap(f"layer{stage}", x)
        x = tap("avgpool", global_avg_pool(x))
        logits = tap("fc", linear(x.flatten(1), params["fc.weight"], params["fc.bias"]))
        taps = {k: v.permute(0, 2, 3, 1) if v.ndim == 4 else v for k, v in tap.taps.items()}
        return logits, taps

    def __repr__(self):
        return f"ResNet(depth={self.depth}, num_classes={self.num_classes})"
