"""Functional torchvision-compatible MaxViT with named taps.

Counterpart of ``semanticlens_tpu.models.maxvit``: MaxViT-T with the module
and parameter names of torchvision's ``maxvit_t``
(``blocks.{s}.layers.{i}.layers.{MBconv,window_attention,grid_attention}``,
the stem pair, the LN → Linear → Tanh → Linear classifier), so its state
dict loads as it is; ``relative_position_index`` is derived, recomputed
here (the port's ``swin._relative_position_index``) and skipped on load.

- Each layer is an MBConv (pre-norm BN with eps 1e-3, 1×1 expand ×4, 3×3
  depthwise with the layer's stride, squeeze-excite on the expanded width
  with a SiLU squeeze, 1×1 project, and an AvgPool(3, 2, 1) + 1×1
  shortcut on stride 2), then window attention, then grid attention.
- Both attentions are pre-LN relative-position multi-head attention over
  p² = 49 tokens and a pre-LN MLP (×4, GELU), with residuals. Grid
  attention partitions into windows of size G/p and swaps the window and
  token axes (and swaps them back after), so it runs over the p×p
  decimated lattice.
- torchvision scales the logits by the full width, ``C**-0.5``: q is
  pre-scaled by ``√(hd/C)`` so that the helper's ``hd**-0.5`` lands there.
  The bias table stays float32 and is added to float32 logits
  (``float32_mask=True``), as in the JAX package.
- Inputs must keep every feature map a multiple of the partition (224-like
  sizes); others raise, as in the JAX package.

The MBConv runs NCHW in channels_last memory and the attention on the
(B, H, W, C) view of the same memory. Conv taps are (B, H, W, C), the
attention sub-blocks' (B, groups, T, C), torchvision's hook shapes.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch

from semanticlens_tpu_torch.models.base import TapCollector
from semanticlens_tpu_torch.models.layers import (
    avg_pool,
    bn_param_specs,
    conv2d,
    gelu,
    layer_norm,
    linear,
    residual_add,
    scaled_dot_product_attention,
)
from semanticlens_tpu_torch.models.swin import _relative_position_index
from semanticlens_tpu_torch.models.zoo import ZooModel
from semanticlens_tpu_torch.utils.device import resolve_device

# variant -> (stem_ch, block_channels, block_layers, head_dim)
_VARIANTS = {"tiny": (64, (64, 128, 256, 512), (2, 2, 5, 2), 32)}
_EXPANSION = 4
_SQUEEZE = 0.25
_MLP_RATIO = 4
_PARTITION = 7


def _nhwc_tap(tap: TapCollector):
    """A tap for NCHW values on a collector that records (B, H, W, C): rank-4 values go through as their NHWC
    view (the collector's other rank-4 values, (B, groups, T, C), are no images)."""

    def conv_tap(name, value):
        if value.ndim == 4:
            return tap(name, value.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return tap(name, value)

    return conv_tap


class MaxViT(ZooModel):
    """MaxViT-T with torchvision-compatible names.

    Parameters
    ----------
    variant : "tiny" (torchvision ships ``maxvit_t``).
    num_classes : classifier width (0 → headless pooled features).
    partition_size : window and grid partition (7 for 224² inputs).
    dtype : activation dtype (bfloat16 by default).
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    bn_eps = 1e-3  # torchvision: partial(BatchNorm2d, eps=1e-3, momentum=0.01)
    LN_EPS = 1e-5

    def __init__(self, variant: str = "tiny", num_classes: int = 1000, *, partition_size: int = _PARTITION,
                 dtype=torch.bfloat16, device=None):
        if variant not in _VARIANTS:
            raise ValueError(f"variant must be one of {sorted(_VARIANTS)}, got {variant!r}")
        self.variant = variant
        self.num_classes = num_classes
        self.dtype = dtype
        self.device = resolve_device(device)
        self.p = partition_size
        self.stem_ch, self.channels, self.layers_per_block, self.head_dim = _VARIANTS[variant]
        self.num_features = self.channels[-1]
        self._rel_index = torch.from_numpy(_relative_position_index(self.p)).to(self.device)
        self.module_names = tuple(self._enumerate_module_names())

    def _layers(self):
        """``(stage, layer, c_in, c_out, stride)`` of every MaxVit layer."""
        c_in = self.stem_ch
        for s, (c_out, n_layers) in enumerate(zip(self.channels, self.layers_per_block)):
            for i in range(n_layers):
                yield s, i, c_in if i == 0 else c_out, c_out, 2 if i == 0 else 1
            c_in = c_out

    # ------------------------------------------------------------------ names
    @staticmethod
    def _layer_names(base: str, c_in: int, c_out: int, stride: int):
        mb = f"{base}.layers.MBconv"
        names = [base, f"{base}.layers", mb]
        if stride != 1 or c_in != c_out:
            names += [f"{mb}.proj", f"{mb}.proj.0", f"{mb}.proj.1"]
        names += [f"{mb}.layers", f"{mb}.layers.pre_norm"]
        for part in ("conv_a", "conv_b"):
            names += [f"{mb}.layers.{part}"] + [f"{mb}.layers.{part}.{j}" for j in range(3)]
        se = f"{mb}.layers.squeeze_excitation"
        names += [se] + [f"{se}.{m}" for m in ("avgpool", "fc1", "activation", "fc2", "scale_activation")]
        names += [f"{mb}.layers.conv_c", f"{mb}.stochastic_depth"]
        for kind in ("window_attention", "grid_attention"):
            at = f"{base}.layers.{kind}"
            names += [at, f"{at}.attn_layer", f"{at}.attn_layer.0", f"{at}.attn_layer.1", f"{at}.mlp_layer"]
            names += [f"{at}.mlp_layer.{j}" for j in range(4)] + [f"{at}.stochastic_depth"]
        return names

    def _enumerate_module_names(self):
        names = ["stem", "stem.0", "stem.0.0", "stem.0.1", "stem.0.2", "stem.1", "stem.1.0", "blocks"]
        for s, i, c_in, c_out, stride in self._layers():
            if i == 0:
                names += [f"blocks.{s}", f"blocks.{s}.layers"]
            names += self._layer_names(f"blocks.{s}.layers.{i}", c_in, c_out, stride)
        names += ["classifier"] + [f"classifier.{j}" for j in (0, 1, 2)]
        return names + ([f"classifier.{j}" for j in (3, 4, 5)] if self.num_classes else [])

    # ------------------------------------------------------------------ params
    @staticmethod
    def _ln_specs(prefix, ch):
        return [(f"{prefix}.weight", (ch,), "ln_w"), (f"{prefix}.bias", (ch,), "zeros")]

    def _param_specs(self):
        specs = [("stem.0.0.weight", (3, 3, 3, self.stem_ch), "conv")] + bn_param_specs("stem.0.1", self.stem_ch)
        specs += [("stem.1.0.weight", (3, 3, self.stem_ch, self.stem_ch), "conv"), ("stem.1.0.bias", (self.stem_ch,),
                                                                                   "zeros")]
        for s, i, cin_i, c_out, stride in self._layers():
            base = f"blocks.{s}.layers.{i}.layers"
            mb, mid = f"{base}.MBconv", c_out * _EXPANSION
            sqz = int(mid * _SQUEEZE)
            if stride != 1 or cin_i != c_out:
                specs += [(f"{mb}.proj.1.weight", (1, 1, cin_i, c_out), "conv"), (f"{mb}.proj.1.bias", (c_out,), "zeros")]
            specs += bn_param_specs(f"{mb}.layers.pre_norm", cin_i)
            specs += [(f"{mb}.layers.conv_a.0.weight", (1, 1, cin_i, mid), "conv")]
            specs += bn_param_specs(f"{mb}.layers.conv_a.1", mid)
            specs += [(f"{mb}.layers.conv_b.0.weight", (3, 3, 1, mid), "dwconv")]
            specs += bn_param_specs(f"{mb}.layers.conv_b.1", mid)
            se = f"{mb}.layers.squeeze_excitation"
            specs += [(f"{se}.fc1.weight", (mid, sqz), "se_fc"), (f"{se}.fc1.bias", (sqz,), "zeros"),
                      (f"{se}.fc2.weight", (sqz, mid), "se_fc"), (f"{se}.fc2.bias", (mid,), "zeros")]
            specs += [(f"{mb}.layers.conv_c.weight", (1, 1, mid, c_out), "conv"),
                      (f"{mb}.layers.conv_c.bias", (c_out,), "zeros")]
            heads = c_out // self.head_dim
            for kind in ("window_attention", "grid_attention"):
                at = f"{base}.{kind}"
                specs += self._ln_specs(f"{at}.attn_layer.0", c_out)
                specs += [(f"{at}.attn_layer.1.to_qkv.weight", (c_out, 3 * c_out), "linear"),
                          (f"{at}.attn_layer.1.to_qkv.bias", (3 * c_out,), "zeros"),
                          (f"{at}.attn_layer.1.merge.weight", (c_out, c_out), "linear"),
                          (f"{at}.attn_layer.1.merge.bias", (c_out,), "zeros"),
                          (f"{at}.attn_layer.1.relative_position_bias_table", ((2 * self.p - 1) ** 2, heads), "zeros")]
                specs += self._ln_specs(f"{at}.mlp_layer.0", c_out)
                specs += [(f"{at}.mlp_layer.1.weight", (c_out, _MLP_RATIO * c_out), "linear"),
                          (f"{at}.mlp_layer.1.bias", (_MLP_RATIO * c_out,), "zeros"),
                          (f"{at}.mlp_layer.3.weight", (_MLP_RATIO * c_out, c_out), "linear"),
                          (f"{at}.mlp_layer.3.bias", (c_out,), "zeros")]
        d = self.num_features
        specs += self._ln_specs("classifier.2", d)
        if self.num_classes:
            specs += [("classifier.3.weight", (d, d), "linear"), ("classifier.3.bias", (d,), "zeros"),
                      ("classifier.5.weight", (d, self.num_classes), "linear")]
        return specs

    def _draw(self, name, shape, kind):
        """Kaiming-normal fan-out convs and SE linears, normal(0.02) linears (torchvision's trunc_normal,
        untruncated), unit norms, zero bias tables: the JAX package's scheme."""
        if kind in ("conv", "dwconv"):
            return "normal", math.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
        if kind == "se_fc":
            return "normal", math.sqrt(2.0 / shape[1])
        if kind == "linear":
            return "normal", 0.02
        return "const", 1.0 if kind in ("bn_w", "ln_w") else 0.0

    # ------------------------------------------------------------------ forward
    def _ln(self, params, prefix, x):
        return layer_norm(x, params[f"{prefix}.weight"], params[f"{prefix}.bias"], eps=self.LN_EPS)

    def _mbconv(self, params, x, mb, c_in, c_out, stride, tap):
        """NCHW in and out; ``tap`` takes NCHW values (:func:`_nhwc_tap`)."""
        if stride != 1 or c_in != c_out:
            sc = tap(f"{mb}.proj.0", avg_pool(x, window=3, stride=stride, padding=1) if stride == 2 else x)
            sc = tap(f"{mb}.proj", tap(f"{mb}.proj.1", conv2d(sc, params[f"{mb}.proj.1.weight"],
                                                              params[f"{mb}.proj.1.bias"])))
        else:
            sc = x
        h = tap(f"{mb}.layers.pre_norm", self._bn(params, f"{mb}.layers.pre_norm", x))
        for part, kernel, stride_p, depthwise in (("conv_a", 1, 1, False), ("conv_b", 3, stride, True)):
            p = f"{mb}.layers.{part}"
            h = tap(f"{p}.0", conv2d(h, params[f"{p}.0.weight"], stride=stride_p, padding=(kernel - 1) // 2,
                                     groups=h.shape[1] if depthwise else 1))
            h = tap(f"{p}.1", self._bn(params, f"{p}.1", h))
            h = tap(p, tap(f"{p}.2", gelu(h)))
        h = self._squeeze_excite(params, h, f"{mb}.layers.squeeze_excitation", tap)
        h = tap(f"{mb}.layers.conv_c", conv2d(h, params[f"{mb}.layers.conv_c.weight"], params[f"{mb}.layers.conv_c.bias"]))
        h = tap(f"{mb}.stochastic_depth", tap(f"{mb}.layers", h))  # identity at inference
        return tap(mb, residual_add(sc, h))

    @staticmethod
    def _partition(x, q: int):
        """(B, H, W, C) → (B·nW, q², C) windows of size q."""
        b, h, w, c = x.shape
        nh, nw = h // q, w // q
        return x.reshape(b, nh, q, nw, q, c).permute(0, 1, 3, 2, 4, 5).reshape(b * nh * nw, q * q, c), (b, nh, nw)

    @staticmethod
    def _departition(x, q: int, dims):
        b, nh, nw = dims
        c = x.shape[-1]
        return x.reshape(b, nh, nw, q, q, c).permute(0, 1, 3, 2, 4, 5).reshape(b, nh * q, nw * q, c)

    def _attention(self, params, xw, at, heads):
        """Relative-position MHA over (N, T, C) token groups, T = p²."""
        t, c = xw.shape[-2], xw.shape[-1]
        p = f"{at}.attn_layer.1"
        qkv = linear(xw, params[f"{p}.to_qkv.weight"], params[f"{p}.to_qkv.bias"])
        # torchvision scales by C**-0.5 (the full width): pre-scale q so that the helper's hd**-0.5 lands there,
        # by the factor in q's dtype, as the JAX package's weakly typed scalar is.
        q = qkv[..., :c] * torch.tensor(math.sqrt((c // heads) / c), dtype=qkv.dtype)
        table = params[f"{p}.relative_position_bias_table"].float()
        bias = table[self._rel_index].reshape(t, t, heads).permute(2, 0, 1)  # (H, T, T)
        out = scaled_dot_product_attention(q, qkv[..., c:2 * c], qkv[..., 2 * c:], heads, mask=bias,
                                           float32_mask=True)
        return linear(out, params[f"{p}.merge.weight"], params[f"{p}.merge.bias"])

    def _partition_attention(self, params, x, at, heads, kind, tap):
        """(B, H, W, C) in and out; taps in torchvision's (B, groups, T, C) hook shape."""
        b, h, w, c = x.shape
        p = self.p
        if h % p or w % p:
            raise ValueError(f"feature map {h}x{w} not divisible by partition {p} at {at} (use 224-like input sizes)")
        q = p if kind == "window" else h // p  # grid: windows of size G/p, then the token and window axes swap
        xw, dims = self._partition(x, q)
        if kind == "grid":
            xw = xw.reshape(dims[0], dims[1] * dims[2], q * q, c).transpose(1, 2).reshape(dims[0] * q * q, -1, c)

        def tap_b(name, z):  # recorded (and rewritten) as (B, groups, T, C); the forward goes on windowed
            return tap(name, z.reshape(b, -1, z.shape[-2], z.shape[-1])).reshape(-1, z.shape[-2], z.shape[-1])

        hh = self._attention(params, tap_b(f"{at}.attn_layer.0", self._ln(params, f"{at}.attn_layer.0", xw)), at,
                             heads)
        hh = tap_b(f"{at}.attn_layer", tap_b(f"{at}.attn_layer.1", hh))
        # one StochasticDepth module for both branches (identity at inference; the last tap wins, as in Swin)
        xw = residual_add(xw, tap_b(f"{at}.stochastic_depth", hh))
        m = tap_b(f"{at}.mlp_layer.0", self._ln(params, f"{at}.mlp_layer.0", xw))
        m = tap_b(f"{at}.mlp_layer.1", linear(m, params[f"{at}.mlp_layer.1.weight"], params[f"{at}.mlp_layer.1.bias"]))
        m = tap_b(f"{at}.mlp_layer.2", gelu(m))
        m = linear(m, params[f"{at}.mlp_layer.3.weight"], params[f"{at}.mlp_layer.3.bias"])
        m = tap_b(f"{at}.stochastic_depth", tap_b(f"{at}.mlp_layer", tap_b(f"{at}.mlp_layer.3", m)))
        xw = residual_add(xw, m)
        if kind == "grid":
            xw = xw.reshape(dims[0], q * q, dims[1] * dims[2], c).transpose(1, 2).reshape(-1, q * q, c)
        return tap(at, self._departition(xw, q, dims))

    def apply(self, params: Mapping, x, tap_names: Sequence[str] = ()):
        """(B, H, W, 3) float → (logits, taps). Conv taps are (B, H, W, C)."""
        tap = TapCollector(tap_names)
        ctap = _nhwc_tap(tap)
        x = ctap("stem.0.0", conv2d(x.permute(0, 3, 1, 2).to(self.dtype), params["stem.0.0.weight"], stride=2,
                                    padding=1))
        x = ctap("stem.0.1", self._bn(params, "stem.0.1", x))
        x = ctap("stem.0", ctap("stem.0.2", gelu(x)))
        x = ctap("stem.1.0", conv2d(x, params["stem.1.0.weight"], params["stem.1.0.bias"], padding=1))
        x = ctap("stem", ctap("stem.1", x)).permute(0, 2, 3, 1)
        for s, i, c_in, c_out, stride in self._layers():
            base, heads = f"blocks.{s}.layers.{i}", c_out // self.head_dim
            x = self._mbconv(params, x.permute(0, 3, 1, 2), f"{base}.layers.MBconv", c_in, c_out, stride,
                             ctap).permute(0, 2, 3, 1)
            x = self._partition_attention(params, x, f"{base}.layers.window_attention", heads, "window", tap)
            x = self._partition_attention(params, x, f"{base}.layers.grid_attention", heads, "grid", tap)
            x = tap(base, tap(f"{base}.layers", x))
            if i == self.layers_per_block[s] - 1:
                x = tap(f"blocks.{s}", tap(f"blocks.{s}.layers", x))
        x = tap("blocks", x)
        x = tap("classifier.0", torch.mean(x, dim=(1, 2), keepdim=True))
        x = tap("classifier.1", x.flatten(1))
        x = tap("classifier.2", self._ln(params, "classifier.2", x))
        if not self.num_classes:
            return x, tap.taps
        x = tap("classifier.3", linear(x, params["classifier.3.weight"], params["classifier.3.bias"]))
        x = tap("classifier.4", torch.tanh(x))
        x = tap("classifier.5", linear(x, params["classifier.5.weight"]))
        return tap("classifier", x), tap.taps

    def __repr__(self):
        return f"MaxViT(variant={self.variant!r}, num_classes={self.num_classes})"
