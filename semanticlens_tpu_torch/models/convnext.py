"""Functional timm-style ConvNeXt with named activation taps.

Counterpart of ``semanticlens_tpu.models.convnext``: ConvNeXt
tiny/small/base/large with timm's ``convnext_*`` names (``stem.0``,
``stages.2.blocks.5.conv_dw`` …), or with ``naming="torchvision"`` the
whole surface (module names, parameter names, checkpoint layout) of
torchvision's graph (``features.5.2.block.0``, ``classifier.2``, a (C, 1, 1)
``layer_scale``); :meth:`ConvNeXt.from_name` builds the torchvision models
``convnext_tiny`` … ``convnext_large``.

A block is a depthwise 7×7 conv (``groups=C``) on NCHW channels_last
memory, then LayerNorm → Linear → GELU → Linear over channels on the NHWC
view of the same memory (a free ``permute``), the layer scale
(``channel_scale``) and ``residual_add``. Taps of the channels-last part are
handed to the tap collector as NCHW views, so they come back (B, H, W, C)
like every conv tap.
"""

from __future__ import annotations

import torch

from semanticlens_tpu_torch.models.layers import channel_scale, conv2d, gelu, layer_norm, linear, residual_add
from semanticlens_tpu_torch.models.zoo import ZooModel
from semanticlens_tpu_torch.utils.device import resolve_device

_PRESETS = {
    # name: (depths per stage, dims per stage)
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
}

_TV_BLOCK = {
    # timm block suffix → torchvision CNBlock suffix (block = Sequential:
    # 0 dwconv, 1 permute, 2 LN, 3 fc1, 4 GELU, 5 fc2, 6 permute)
    "conv_dw": "block.0",
    "norm": "block.2",
    "mlp.fc1": "block.3",
    "mlp.fc2": "block.5",
    "mlp": "block",  # the Sequential's output is fc2's (the permutes are layout only)
    "gamma": "layer_scale",
}


def _to_torchvision(name: str) -> str:
    """Canonical (timm) module or parameter name → torchvision's ``convnext_*`` naming.

    stem = ``features.0``, stage i = ``features.{2i+1}``, downsample i =
    ``features.{2i}``, head = ``classifier`` (0 = LN, 2 = Linear).
    """
    if name == "stem" or name.startswith("stem."):
        return name.replace("stem", "features.0", 1)
    if name == "stages":
        return "features"
    if name.startswith("stages."):
        parts = name.split(".")
        i, tail = int(parts[1]), parts[2:]
        if tail and tail[0] == "downsample":
            return ".".join([f"features.{2 * i}"] + tail[1:])
        if tail and tail[0] == "blocks":
            base, rest = f"features.{2 * i + 1}.{tail[1]}", tail[2:]
            if not rest:
                return base
            key = ".".join(rest)
            for timm_sfx, tv_sfx in _TV_BLOCK.items():
                if key == timm_sfx or key.startswith(timm_sfx + "."):
                    return f"{base}.{key.replace(timm_sfx, tv_sfx, 1)}"
            raise KeyError(f"no torchvision mapping for block member {key!r}")
        return f"features.{2 * i + 1}"
    if name == "head":
        return "classifier"
    if name.startswith("head.norm"):
        return name.replace("head.norm", "classifier.0", 1)
    if name.startswith("head.fc"):
        return name.replace("head.fc", "classifier.2", 1)
    return name


class ConvNeXt(ZooModel):
    """ConvNeXt-T/S/B/L classifier with timm-compatible (or torchvision) names.

    Parameters
    ----------
    variant : "tiny" | "small" | "base" | "large".
    num_classes : classifier width (0 → pooled features, no head).
    dtype : activation dtype (bfloat16 by default).
    naming : ``"timm"`` or ``"torchvision"``.
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    def __init__(self, variant: str = "tiny", num_classes: int = 1000, dtype=torch.bfloat16, naming: str = "timm",
                 device=None):
        if variant not in _PRESETS:
            raise ValueError(f"Unknown ConvNeXt variant '{variant}'; expected {sorted(_PRESETS)}")
        if naming not in ("timm", "torchvision"):
            raise ValueError(f"naming must be 'timm' or 'torchvision', got {naming!r}")
        self.variant = variant
        self.depths, self.dims = _PRESETS[variant]
        self.num_classes = num_classes
        self.dtype = dtype
        self.naming = naming
        self.device = resolve_device(device)
        self.module_names = tuple(self._enumerate_module_names())

    @classmethod
    def from_name(cls, name: str, *, num_classes: int = 1000, dtype=torch.bfloat16, device=None):
        """A torchvision-named ConvNeXt from its zoo name (``convnext_tiny`` … ``convnext_large``)."""
        variant = name.removeprefix("convnext_")
        if not name.startswith("convnext_") or variant not in _PRESETS:
            raise ValueError(f"name must be one of {sorted('convnext_' + v for v in _PRESETS)}, got {name!r}")
        return cls(variant=variant, num_classes=num_classes, dtype=dtype, naming="torchvision", device=device)

    def _n(self, name: str) -> str:
        """A canonical (timm) name in the active naming."""
        return name if self.naming == "timm" else _to_torchvision(name)

    # ------------------------------------------------------------------ names
    def _enumerate_module_names(self):
        names = ["stem", "stem.0", "stem.1", "stages"]
        for i, depth in enumerate(self.depths):
            p = f"stages.{i}"
            names.append(p)
            if i > 0:
                names += [f"{p}.downsample", f"{p}.downsample.0", f"{p}.downsample.1"]
            for j in range(depth):
                b = f"{p}.blocks.{j}"
                names += [b, f"{b}.conv_dw", f"{b}.norm", f"{b}.mlp", f"{b}.mlp.fc1", f"{b}.mlp.fc2"]
        names += ["head", "head.norm"] + (["head.fc"] if self.num_classes else [])
        if self.naming == "timm":
            return names
        return [_to_torchvision(n) for n in names] + ["avgpool"]  # torchvision's own pool module

    # ------------------------------------------------------------------ params
    def _param_specs(self):
        d0 = self.dims[0]
        specs = [("stem.0.weight", (4, 4, 3, d0), "conv"), ("stem.0.bias", (d0,), "zeros"),
                 ("stem.1.weight", (d0,), "ones"), ("stem.1.bias", (d0,), "zeros")]
        for i, (depth, dim) in enumerate(zip(self.depths, self.dims)):
            p = f"stages.{i}"
            if i > 0:
                prev = self.dims[i - 1]
                specs += [(f"{p}.downsample.0.weight", (prev,), "ones"), (f"{p}.downsample.0.bias", (prev,), "zeros"),
                          (f"{p}.downsample.1.weight", (2, 2, prev, dim), "conv"),
                          (f"{p}.downsample.1.bias", (dim,), "zeros")]
            for j in range(depth):
                b = f"{p}.blocks.{j}"
                specs += [
                    (f"{b}.conv_dw.weight", (7, 7, 1, dim), "conv"),
                    (f"{b}.conv_dw.bias", (dim,), "zeros"),
                    (f"{b}.norm.weight", (dim,), "ones"),
                    (f"{b}.norm.bias", (dim,), "zeros"),
                    (f"{b}.mlp.fc1.weight", (dim, 4 * dim), "fc"),
                    (f"{b}.mlp.fc1.bias", (4 * dim,), "zeros"),
                    (f"{b}.mlp.fc2.weight", (4 * dim, dim), "fc"),
                    (f"{b}.mlp.fc2.bias", (dim,), "zeros"),
                    (f"{b}.gamma", (dim,), "gamma"),
                ]
        dl = self.dims[-1]
        specs += [("head.norm.weight", (dl,), "ones"), ("head.norm.bias", (dl,), "zeros")]
        if self.num_classes:
            specs += [("head.fc.weight", (dl, self.num_classes), "fc"), ("head.fc.bias", (self.num_classes,), "zeros")]
        return [(self._n(n), shape, kind) for n, shape, kind in specs]

    def _draw(self, name, shape, kind):
        """Normal(0, 0.02) convs and linears (timm's trunc_normal(0.02), untruncated), 1e-6 layer scale."""
        if kind in ("conv", "fc"):
            return "normal", 0.02
        return "const", {"ones": 1.0, "gamma": 1e-6}.get(kind, 0.0)

    # ------------------------------------------------------------------ apply
    def _ln_channels(self, p_, prefix, x):
        """LayerNorm over the channels of NCHW ``x``, on its NHWC view."""
        return self._ln(p_, prefix, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    @staticmethod
    def _ln(p_, prefix, x):
        return layer_norm(x, p_(f"{prefix}.weight"), p_(f"{prefix}.bias"), eps=1e-6)

    def _block(self, p_, prefix, x, tap):
        def tap_nhwc(name, h):  # a channels-last value tapped as the NCHW view of the same memory
            return tap(name, h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

        h = conv2d(x, p_(f"{prefix}.conv_dw.weight"), p_(f"{prefix}.conv_dw.bias"), padding=3, groups=x.shape[1])
        h = tap(f"{prefix}.conv_dw", h).permute(0, 2, 3, 1)
        h = tap_nhwc(f"{prefix}.norm", self._ln(p_, f"{prefix}.norm", h))
        h = tap_nhwc(f"{prefix}.mlp.fc1", linear(h, p_(f"{prefix}.mlp.fc1.weight"), p_(f"{prefix}.mlp.fc1.bias")))
        h = gelu(h, approximate=False)
        h = tap_nhwc(f"{prefix}.mlp.fc2", linear(h, p_(f"{prefix}.mlp.fc2.weight"), p_(f"{prefix}.mlp.fc2.bias")))
        h = tap_nhwc(f"{prefix}.mlp", h)
        h = channel_scale(h, p_(f"{prefix}.gamma").reshape(-1)).permute(0, 3, 1, 2)
        return tap(prefix, residual_add(x, h))

    def _forward(self, params, x, tapc):
        def tap(name, value):
            return tapc(self._n(name), value)

        def p_(key):
            return params[self._n(key)]

        x = tap("stem.0", conv2d(x, p_("stem.0.weight"), p_("stem.0.bias"), stride=4))
        x = tap("stem.1", self._ln_channels(p_, "stem.1", x))
        x = tap("stem", x)
        for i, depth in enumerate(self.depths):
            p = f"stages.{i}"
            if i > 0:
                x = tap(f"{p}.downsample.0", self._ln_channels(p_, f"{p}.downsample.0", x))
                x = tap(f"{p}.downsample.1", conv2d(x, p_(f"{p}.downsample.1.weight"), p_(f"{p}.downsample.1.bias"),
                                                    stride=2))
                x = tap(f"{p}.downsample", x)
            for j in range(depth):
                x = self._block(p_, f"{p}.blocks.{j}", x, tap)
            x = tap(p, x)
        x = tap("stages", x)

        pooled = torch.mean(x, dim=(2, 3))
        if self.naming == "torchvision":
            pooled = tapc("avgpool", pooled)  # torchvision pools before the classifier's LN
        pooled = tap("head.norm", self._ln(p_, "head.norm", pooled))
        if self.num_classes:
            return tap("head", tap("head.fc", linear(pooled, p_("head.fc.weight"), p_("head.fc.bias"))))
        return tap("head", pooled)

    def __repr__(self):
        return f"ConvNeXt(variant='{self.variant}', num_classes={self.num_classes}, naming={self.naming!r})"
