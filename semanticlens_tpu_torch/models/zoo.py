"""What the vision zoo's families share: weights drawn by spec kind, loaders, and the NCHW forward frame.

Each family (``resnet``, ``vgg``, ``densenet``, ``convnext``,
``efficientnet``, ``mobilenet``, ``mnasnet``, ``regnet``, ``shufflenet``,
``classic``, ``inception``, ``swin``, ``maxvit``) mirrors its JAX
counterpart: the class, constructor arguments, ``module_names``, tap names
and ``_param_specs`` rows (name, shape in the JAX layout, init kind). The
port keeps torch's layouts (conv OIHW, linear (out, in), squeeze-excite
1×1 convs (out, in, 1, 1)), so a torchvision or timm state dict loads as it
is, checked against the specs (``layers.load_torch_params``); JAX-layout
weights come through ``convert.zoo_params_from_jax``.

The forward runs NCHW in channels_last memory. ``apply`` takes the JAX
layout, (B, H, W, 3), and returns conv taps as (B, H, W, C); interventions
see that layout too (``TapCollector(channels_first=True)``). Swin and
MaxViT, whose token stages run (B, H, W, C) as in the JAX package, give
their own ``apply``.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch.models.base import SubjectModel, TapCollector
from semanticlens_tpu_torch.models.layers import (
    batch_norm,
    bn_param_specs,
    conv2d,
    gate_scale,
    global_avg_pool,
    linear,
    load_torch_params,
)


def cna_names(prefix: str, act: bool = True) -> list[str]:
    """Module names of one torchvision ``Conv2dNormActivation``: itself, conv, BN and (act)."""
    return [prefix, f"{prefix}.0", f"{prefix}.1"] + ([f"{prefix}.2"] if act else [])


def conv_bn_specs(prefix: str, k: int, c_in: int, c_out: int, kind: str = "conv") -> list:
    """Spec rows of one ``Conv2dNormActivation``'s conv (HWIO; depthwise ``(k, k, 1, C)``) and BN."""
    return [(f"{prefix}.0.weight", (k, k, 1 if kind == "dwconv" else c_in, c_out), kind)] + bn_param_specs(
        f"{prefix}.1", c_out)


def se_names(prefix: str) -> list[str]:
    """Module names of one torchvision ``SqueezeExcitation``."""
    return [prefix] + [f"{prefix}.{m}" for m in ("avgpool", "fc1", "activation", "fc2", "scale_activation")]


def se_specs(prefix: str, ch: int, squeeze: int) -> list:
    """Spec rows of one ``SqueezeExcitation``: its 1×1 convs as (in, out) linears in the JAX layout."""
    return [(f"{prefix}.fc1.weight", (ch, squeeze), "se_fc"), (f"{prefix}.fc1.bias", (squeeze,), "zeros"),
            (f"{prefix}.fc2.weight", (squeeze, ch), "se_fc"), (f"{prefix}.fc2.bias", (ch,), "zeros")]


def nhwc_taps(tap: TapCollector) -> dict[str, torch.Tensor]:
    """The recorded taps with rank-4 (NCHW) values as (B, H, W, C) views."""
    return {k: v.permute(0, 2, 3, 1) if v.ndim == 4 else v for k, v in tap.taps.items()}


class ZooModel(SubjectModel):
    """A vision family described by ``_param_specs``; subclasses give ``_draw``, ``_forward`` and ``bn_eps``.

    ``dtype`` is the activation dtype, ``device`` where parameters live and
    the forward runs.
    """

    bn_eps = 1e-5
    dtype: torch.dtype
    device: torch.device

    def _param_specs(self) -> list[tuple[str, tuple[int, ...], str]]:
        raise NotImplementedError

    def _draw(self, name, shape, kind) -> tuple[str, float]:
        """How to draw the tensor ``name`` of ``kind``: ``("normal", std)``, ``("uniform", bound)`` or ``("const", v)``."""
        raise NotImplementedError

    def _forward(self, params: Mapping, x: torch.Tensor, tap: TapCollector) -> torch.Tensor:
        raise NotImplementedError

    # ------------------------------------------------------------------ weights
    def init_jax_layout(self, seed: int = 0) -> dict[str, np.ndarray]:
        """Random float32 numpy weights in the JAX package's layout, by the family's init kinds.

        The JAX package's scheme, drawn from ``np.random`` with ``seed`` (the
        streams differ from ``jax.random``'s), one tensor after the other in
        spec order.
        """
        rng = np.random.default_rng(seed)
        params = {}
        for name, shape, kind in self._param_specs():
            how, value = self._draw(name, shape, kind)
            if how == "normal":
                params[name] = rng.standard_normal(shape, np.float32) * np.float32(value)
            elif how == "uniform":
                params[name] = rng.uniform(-value, value, shape).astype(np.float32)
            else:
                params[name] = np.full(shape, value, np.float32)
        return params

    def init(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Random weights from ``seed``, placed on the model's device."""
        return self.load_jax_params(self.init_jax_layout(seed))

    def load_jax_params(self, params: Mapping) -> dict[str, torch.Tensor]:
        """Weights in the JAX package's layout → the port's, placed for the forward."""
        return self.load_torch_state_dict(convert.zoo_params_from_jax(params, self._param_specs()))

    def load_torch_state_dict(self, state_dict: Mapping) -> dict[str, torch.Tensor]:
        """A torchvision (timm for ResNet-D and timm-named ConvNeXt) state dict, checked and placed."""
        return load_torch_params(self._param_specs(), state_dict, device=self.device, dtype=self.dtype)

    # ------------------------------------------------------------------ forward
    def apply(self, params: Mapping, x, tap_names: Sequence[str] = ()):
        """Forward pass. x: (B, H, W, 3) float. Returns (output, taps), conv taps (B, H, W, C)."""
        tap = TapCollector(tap_names, channels_first=True)
        out = self._forward(params, x.permute(0, 3, 1, 2).to(self.dtype), tap)
        return out, nhwc_taps(tap)

    def _bn(self, params, prefix, x):
        return batch_norm(x, params[f"{prefix}.weight"], params[f"{prefix}.bias"],
                          params[f"{prefix}.running_mean"], params[f"{prefix}.running_var"], eps=self.bn_eps)

    def _cna(self, params, x, prefix, tap, *, stride=1, kernel=1, groups=1, act=None):
        """One torchvision ``Conv2dNormActivation``: conv → BN → (act), tapped at ``.0``, ``.1``, ``.2``."""
        x = tap(f"{prefix}.0", conv2d(x, params[f"{prefix}.0.weight"], stride=stride, padding=(kernel - 1) // 2,
                                      groups=groups))
        x = tap(f"{prefix}.1", self._bn(params, f"{prefix}.1", x))
        if act is not None:
            x = tap(f"{prefix}.2", act(x))
        return tap(prefix, x)

    def _squeeze_excite(self, params, x, prefix, tap, *, squeeze=F.silu, gate=torch.sigmoid):
        """torchvision ``SqueezeExcitation``: pool, ``fc1`` → ``squeeze`` → ``fc2`` → ``gate``, x scaled.

        The 1×1 convs run as linears on the pooled (B, C) rows, as in the JAX
        package (their (out, in, 1, 1) weights flattened, a view). Under LRP
        the gate is a constant (``gate_scale``, CP-LRP): the branch carries
        no relevance, so its activations stay raw.
        """
        pooled = tap(f"{prefix}.avgpool", global_avg_pool(x))
        s = pooled.flatten(1)
        s = tap(f"{prefix}.fc1", linear(s, params[f"{prefix}.fc1.weight"].flatten(1), params[f"{prefix}.fc1.bias"]))
        s = tap(f"{prefix}.activation", squeeze(s))
        s = tap(f"{prefix}.fc2", linear(s, params[f"{prefix}.fc2.weight"].flatten(1), params[f"{prefix}.fc2.bias"]))
        s = tap(f"{prefix}.scale_activation", gate(s))
        return tap(prefix, gate_scale(x, s[:, :, None, None]))
