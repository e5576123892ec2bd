"""Functional torchvision-compatible ResNets with named activation taps.

Counterpart of ``semanticlens_tpu.models.resnet``: ResNet-18/34/50/101/152
(torchvision v1.5, variant ``""``), the timm ``-D`` variant (``"d"``: deep
3×3 stem of width 32, avg-pool shortcut, timm names) and torchvision's
ResNeXt and Wide ResNet (``groups``, ``width_per_group``), with their
module and parameter names, so their state dicts load as they are. The
forward runs NCHW in channels_last memory (cuDNN's preferred layout);
``apply`` takes and returns the JAX package's layouts: (B, H, W, 3) input,
(B, H, W, C) conv taps. Inference-mode BN. The residual joins go through
``layers.residual_add``, which is ``out + identity`` outside an LRP
composite and splits relevance proportionally inside one.

``quantize="int8"`` puts every stage convolution (``layer*``) on the int8
path of :mod:`semanticlens_tpu_torch.ops.quant`: int8 weights per output
channel, int8 activations per sample, an int32 im2col product. The stem,
the BNs and ``fc`` stay float, and LRP dequantizes.
"""

from __future__ import annotations

import math

import torch

from semanticlens_tpu_torch.models.layers import (
    avg_pool,
    bn_param_specs,
    conv2d,
    global_avg_pool,
    linear,
    max_pool,
    residual_add,
)
from semanticlens_tpu_torch.models.zoo import ZooModel
from semanticlens_tpu_torch.ops.quant import quantize_params
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
    return bn_param_specs(prefix, ch, ones_kind="bn_scale", zeros_kind="bias")


class ResNet(ZooModel):
    """ResNet-18/34/50/101/152 with torch-compatible names.

    Parameters
    ----------
    depth : one of 18, 34, 50, 101, 152.
    num_classes : classifier width.
    dtype : activation dtype (bfloat16 by default).
    variant : ``""`` for torchvision ResNet-v1.5, or ``"d"`` for the timm
        -D architecture (deep 3×3 stem of width 32, avg-pool shortcut), with
        timm's names (``conv1.0`` … ``conv1.6``, ``downsample.1/2``). Its
        shortcut pool is the JAX package's floor-mode average, not timm's
        ``ceil_mode``/``count_include_pad=False`` one; they agree on even
        feature maps.
    groups, width_per_group : torchvision's ResNeXt / Wide ResNet knobs
        (bottleneck depths only): ``groups=32, width_per_group=4`` is
        ``resnext50_32x4d``, ``width_per_group=128`` is ``wide_resnet50_2``.
        The bottleneck's inner width is ``int(planes * width_per_group / 64) * groups``.
    quantize : ``None`` (default) or ``"int8"``: the stage convolutions
        run int8 (module docstring). Opt-in only: it perturbs the tapped
        activations within quantization noise, and ``repr`` (the ActMax
        cache key) says so.
    device : where parameters live and the forward runs; ``None`` → the
        CUDA card (raises without one); pass ``"cpu"`` for the CPU.
    """

    STEM_WIDTH_D = 32  # timm resnet*d default

    def __init__(self, depth: int = 18, num_classes: int = 1000, dtype=torch.bfloat16, variant: str = "",
                 groups: int = 1, width_per_group: int = 64, quantize: str | None = None, device=None):
        if depth not in _STAGE_BLOCKS:
            raise ValueError(f"Unsupported ResNet depth {depth}")
        if variant not in ("", "d"):
            raise ValueError(f"Unsupported ResNet variant {variant!r}; expected '' or 'd'")
        if quantize not in (None, "int8"):
            raise ValueError(f"Unsupported quantize mode {quantize!r}; expected None or 'int8'")
        self.quantize = quantize
        self.depth = depth
        self.variant = variant
        self.num_classes = num_classes
        self.dtype = dtype
        self.device = resolve_device(device)
        self.bottleneck = depth in _BOTTLENECK
        if (groups != 1 or width_per_group != 64) and not self.bottleneck:
            raise ValueError("groups/width_per_group configure bottleneck ResNets only "
                             "(torchvision raises the same constraint)")
        self.groups = groups
        self.width_per_group = width_per_group
        self.expansion = 4 if self.bottleneck else 1
        self.stage_blocks = _STAGE_BLOCKS[depth]
        self.module_names = tuple(self._enumerate_module_names())

    def _inner_width(self, stage: int) -> int:
        """Bottleneck conv2 width: torchvision's ``Bottleneck.__init__`` formula."""
        planes = 64 * (2 ** (stage - 1))
        return int(planes * self.width_per_group / 64) * self.groups

    # ------------------------------------------------------------------ names
    def _block_module_names(self, prefix: str, has_downsample: bool):
        convs = ("conv1", "bn1", "conv2", "bn2", "conv3", "bn3") if self.bottleneck else (
            "conv1", "bn1", "conv2", "bn2")
        names = [prefix] + [f"{prefix}.{n}" for n in convs] + [f"{prefix}.relu"]
        if has_downsample:
            names.append(f"{prefix}.downsample")
            names += [f"{prefix}.downsample.{i}" for i in ((0, 1, 2) if self.variant == "d" else (0, 1))]
        return names

    def _enumerate_module_names(self):
        if self.variant == "d":
            names = ["conv1"] + [f"conv1.{i}" for i in range(7)] + ["bn1", "relu", "maxpool"]
        else:
            names = ["conv1", "bn1", "relu", "maxpool"]
        in_ch = 64
        for stage, n_blocks in enumerate(self.stage_blocks, start=1):
            out_ch = 64 * (2 ** (stage - 1)) * self.expansion
            names.append(f"layer{stage}")
            for b in range(n_blocks):
                names += self._block_module_names(f"layer{stage}.{b}", b == 0 and (stage > 1 or in_ch != out_ch))
            in_ch = out_ch
        return names + ["avgpool", "fc"]

    # ------------------------------------------------------------------ params
    def _param_specs(self):
        """(name, shape, kind) for every tensor, shapes in the JAX layout."""
        if self.variant == "d":
            sw = self.STEM_WIDTH_D
            specs = [("conv1.0.weight", _conv_shape(sw, 3, 3), "conv")] + _bn_specs("conv1.1", sw)
            specs += [("conv1.3.weight", _conv_shape(sw, sw, 3), "conv")] + _bn_specs("conv1.4", sw)
            specs += [("conv1.6.weight", _conv_shape(64, sw, 3), "conv")] + _bn_specs("bn1", 64)
        else:
            specs = [("conv1.weight", _conv_shape(64, 3, 7), "conv")] + _bn_specs("bn1", 64)
        in_ch = 64
        for stage, n_blocks in enumerate(self.stage_blocks, start=1):
            width = self._inner_width(stage) if self.bottleneck else 64 * (2 ** (stage - 1))
            out_ch = 64 * (2 ** (stage - 1)) * self.expansion
            for b in range(n_blocks):
                p = f"layer{stage}.{b}"
                if self.bottleneck:
                    specs += [(f"{p}.conv1.weight", _conv_shape(width, in_ch, 1), "conv")]
                    specs += _bn_specs(f"{p}.bn1", width)
                    specs += [(f"{p}.conv2.weight", _conv_shape(width, width // self.groups, 3), "conv")]
                    specs += _bn_specs(f"{p}.bn2", width)
                    specs += [(f"{p}.conv3.weight", _conv_shape(out_ch, width, 1), "conv")]
                    specs += _bn_specs(f"{p}.bn3", out_ch)
                else:
                    specs += [(f"{p}.conv1.weight", _conv_shape(width, in_ch, 3), "conv")]
                    specs += _bn_specs(f"{p}.bn1", width)
                    specs += [(f"{p}.conv2.weight", _conv_shape(width, width, 3), "conv")]
                    specs += _bn_specs(f"{p}.bn2", width)
                if b == 0 and (stage > 1 or in_ch != out_ch):
                    conv, bn = ("downsample.1", "downsample.2") if self.variant == "d" else ("downsample.0",
                                                                                           "downsample.1")
                    specs += [(f"{p}.{conv}.weight", _conv_shape(out_ch, in_ch, 1), "conv")]
                    specs += _bn_specs(f"{p}.{bn}", out_ch)
                in_ch = out_ch
        specs += [
            ("fc.weight", (512 * self.expansion, self.num_classes), "linear"),
            ("fc.bias", (self.num_classes,), "bias"),
        ]
        return specs

    def _draw(self, name, shape, kind):
        """Kaiming-normal convs (fan_out, torchvision's default), uniform fc, unit BN: the JAX package's scheme."""
        if kind == "conv":
            return "normal", math.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
        if kind == "linear":
            return "uniform", 1.0 / math.sqrt(shape[0])
        return "const", 1.0 if kind == "bn_scale" else 0.0

    def load_torch_state_dict(self, state_dict):
        """A torchvision (timm for -D) state dict, checked and placed; stage convs int8 when quantized.

        The int8 weights are quantized from the float32 weights, as in the
        JAX package, not from their copies in the compute dtype.
        """
        params = super().load_torch_state_dict(state_dict)
        if self.quantize:
            params.update({name: torch.as_tensor(state_dict[name]).to(self.device, torch.float32)
                           for name in self._quantized_names()})
        return self._maybe_quantize(params)

    def _quantized_names(self) -> set[str]:
        """The stage convolutions, by the specs' kind (``downsample.1`` is a conv in -D, a BN in v1.5)."""
        return {name for name, _, kind in self._param_specs() if kind == "conv" and name.startswith("layer")}

    def _maybe_quantize(self, params: dict) -> dict:
        """The stage convolutions int8-quantized when ``quantize='int8'``; the stem, BNs and ``fc`` stay float."""
        if self.quantize != "int8":
            return params
        return quantize_params(params, self._quantized_names().__contains__)

    # ------------------------------------------------------------------ apply
    def _has_downsample(self, params, prefix):
        return f"{prefix}.downsample.{1 if self.variant == 'd' else 0}.weight" in params

    def _downsample(self, params, prefix, x, stride, tap):
        """Shortcut projection: strided 1×1 conv (v1.5) or avg-pool + 1×1 conv (-D)."""
        if self.variant == "d":
            h = tap(f"{prefix}.downsample.0", avg_pool(x, window=stride, stride=stride) if stride > 1 else x)
            h = tap(f"{prefix}.downsample.1", conv2d(h, params[f"{prefix}.downsample.1.weight"]))
            h = tap(f"{prefix}.downsample.2", self._bn(params, f"{prefix}.downsample.2", h))
        else:
            h = tap(f"{prefix}.downsample.0", conv2d(x, params[f"{prefix}.downsample.0.weight"], stride=stride))
            h = tap(f"{prefix}.downsample.1", self._bn(params, f"{prefix}.downsample.1", h))
        return tap(f"{prefix}.downsample", h)

    def _basic_block(self, params, prefix, x, stride, tap):
        identity = x
        out = tap(f"{prefix}.conv1", conv2d(x, params[f"{prefix}.conv1.weight"], stride=stride, padding=1))
        out = torch.relu(tap(f"{prefix}.bn1", self._bn(params, f"{prefix}.bn1", out)))
        out = tap(f"{prefix}.conv2", conv2d(out, params[f"{prefix}.conv2.weight"], padding=1))
        out = tap(f"{prefix}.bn2", self._bn(params, f"{prefix}.bn2", out))
        if self._has_downsample(params, prefix):
            identity = self._downsample(params, prefix, x, stride, tap)
        out = tap(f"{prefix}.relu", torch.relu(residual_add(out, identity)))
        return tap(prefix, out)

    def _bottleneck_block(self, params, prefix, x, stride, tap):
        identity = x
        out = tap(f"{prefix}.conv1", conv2d(x, params[f"{prefix}.conv1.weight"]))
        out = torch.relu(tap(f"{prefix}.bn1", self._bn(params, f"{prefix}.bn1", out)))
        out = tap(f"{prefix}.conv2", conv2d(out, params[f"{prefix}.conv2.weight"], stride=stride, padding=1,
                                            groups=self.groups))
        out = torch.relu(tap(f"{prefix}.bn2", self._bn(params, f"{prefix}.bn2", out)))
        out = tap(f"{prefix}.conv3", conv2d(out, params[f"{prefix}.conv3.weight"]))
        out = tap(f"{prefix}.bn3", self._bn(params, f"{prefix}.bn3", out))
        if self._has_downsample(params, prefix):
            identity = self._downsample(params, prefix, x, stride, tap)
        out = tap(f"{prefix}.relu", torch.relu(residual_add(out, identity)))
        return tap(prefix, out)

    def _forward(self, params, x, tap):
        if self.variant == "d":
            x = tap("conv1.0", conv2d(x, params["conv1.0.weight"], stride=2, padding=1))
            x = torch.relu(tap("conv1.1", self._bn(params, "conv1.1", x)))
            x = tap("conv1.3", conv2d(x, params["conv1.3.weight"], padding=1))
            x = torch.relu(tap("conv1.4", self._bn(params, "conv1.4", x)))
            x = tap("conv1", tap("conv1.6", conv2d(x, params["conv1.6.weight"], padding=1)))
        else:
            x = tap("conv1", conv2d(x, params["conv1.weight"], stride=2, padding=3))
        x = tap("bn1", self._bn(params, "bn1", x))
        x = tap("relu", torch.relu(x))
        x = tap("maxpool", max_pool(x, window=3, stride=2, padding=1))
        block_fn = self._bottleneck_block if self.bottleneck else self._basic_block
        for stage, n_blocks in enumerate(self.stage_blocks, start=1):
            for b in range(n_blocks):
                x = block_fn(params, f"layer{stage}.{b}", x, 2 if (stage > 1 and b == 0) else 1, tap)
            x = tap(f"layer{stage}", x)
        x = tap("avgpool", global_avg_pool(x))
        return tap("fc", linear(x.flatten(1), params["fc.weight"], params["fc.bias"]))

    def __repr__(self):
        v = f", variant='{self.variant}'" if self.variant else ""
        if self.groups != 1 or self.width_per_group != 64:
            v += f", groups={self.groups}, width_per_group={self.width_per_group}"
        if self.quantize:  # the ActMax cache key: a quantized model's taps are not its float twin's
            v += f", quantize='{self.quantize}'"
        return f"ResNet(depth={self.depth}, num_classes={self.num_classes}{v})"
