"""Functional torchvision-compatible Swin Transformer and Swin-V2 with named taps.

Counterpart of ``semanticlens_tpu.models.swin``: Swin-T/S/B and Swin-V2-T/S/B
with the module and parameter names of torchvision's ``swin_{t,s,b}`` /
``swin_v2_{t,s,b}`` (``features.{0,2,4,6}`` patch embedding and merges,
``features.{1,3,5,7}`` block stages), so their state dicts load as they
are; ``relative_position_index`` and V2's ``relative_coords_table`` are
derived buffers, recomputed here and skipped on load.

After the patch conv the forward stays (B, H, W, C), as torchvision's and
the JAX package's do, and so do the taps. Details that carry checkpoint
fidelity:

- shifted windows pad H and W up to window multiples, clamp the shift to 0
  when the window covers the (padded) map, mask cross-region pairs with
  −100 (torchvision's value, not −inf) and let the zero pad tokens attend;
- the relative-position bias (V1's learned table, V2's ``16·sigmoid`` of
  the continuous-position-bias MLP) stays float32 and is added to float32
  logits with the region mask, as the JAX package adds its masks
  (``layers.scaled_dot_product_attention(float32_mask=True)``); the region
  mask is a (windows, 1, T, T) period over the batch, never one copy per
  image;
- patch merging concatenates the four parities in torchvision's order
  (0::2/0::2, 1::2/0::2, 0::2/1::2, 1::2/1::2); V1 normalises (LN(4C))
  before the bias-free reduction, V2 after it (LN(2C));
- V2: window 8, cosine attention (q and k L2-normalised per head in
  float32, q scaled by ``exp(min(logit_scale, log 100))·√hd`` so that the
  helper's 1/√hd cancels), post-norm blocks. As in the JAX package, the k
  part of ``qkv.bias`` is used as it is (torchvision zeroes it in its
  forward).

Under LRP the attention is CP-LRP (the probabilities, bias and region mask
included, are constants), LayerNorm the detached-denominator rule and the
residuals the proportional split; the bias paths carry no relevance.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from semanticlens_tpu_torch.models.base import TapCollector
from semanticlens_tpu_torch.models.layers import (
    conv2d,
    gelu,
    layer_norm,
    linear,
    residual_add,
    scaled_dot_product_attention,
)
from semanticlens_tpu_torch.models.zoo import ZooModel
from semanticlens_tpu_torch.utils.device import resolve_device

# variant -> (embed_dim, depths, heads)
_VARIANTS = {
    "tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "small": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "base": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
}
_WINDOW = 7
_PATCH = 4
_MLP_RATIO = 4


def _relative_position_index(ws: int) -> np.ndarray:
    """torchvision ``define_relative_position_index``: (ws⁴,) rows of the ((2ws−1)², heads) table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, T, T)
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).reshape(-1)


def _shift_region_mask(pad_h: int, pad_w: int, ws: int, sh: int, sw: int) -> np.ndarray:
    """(nW, T, T) additive mask, torchvision's −100 for cross-region pairs of shifted windows (per-axis shifts)."""
    regions = np.zeros((pad_h, pad_w), np.int32)
    cnt = 0
    for hs in ((0, pad_h - ws), (pad_h - ws, pad_h - sh), (pad_h - sh, pad_h)):
        for wslice in ((0, pad_w - ws), (pad_w - ws, pad_w - sw), (pad_w - sw, pad_w)):
            regions[hs[0]:hs[1], wslice[0]:wslice[1]] = cnt
            cnt += 1
    win = regions.reshape(pad_h // ws, ws, pad_w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _relative_coords_table(ws: int) -> np.ndarray:
    """torchvision V2's log-spaced CPB input: ((2ws−1)², 2) of (Δh, Δw) / (ws−1) · 8, then sign·log2(1+|x|)/3."""
    rel = np.arange(-(ws - 1), ws, dtype=np.float32)
    h, w = np.meshgrid(rel, rel, indexing="ij")
    table = np.stack([h, w], axis=-1).reshape(-1, 2) / (ws - 1) * 8.0
    return np.sign(table) * np.log2(1.0 + np.abs(table)) / np.log2(8.0)


class SwinTransformer(ZooModel):
    """Swin-T/S/B (v1) with torchvision-compatible names.

    Parameters
    ----------
    variant : "tiny" | "small" | "base".
    num_classes : classifier width (0 → headless pooled features).
    dtype : activation dtype (bfloat16 by default).
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    LN_EPS = 1e-5
    window = _WINDOW

    def __init__(self, variant: str = "tiny", num_classes: int = 1000, *, dtype=torch.bfloat16, device=None):
        if variant not in _VARIANTS:
            raise ValueError(f"variant must be one of {sorted(_VARIANTS)}, got {variant!r}")
        self.variant = variant
        self.num_classes = num_classes
        self.dtype = dtype
        self.device = resolve_device(device)
        self.embed_dim, self.depths, self.heads = _VARIANTS[variant]
        self.num_features = self.embed_dim * 8
        self._rel_index = torch.from_numpy(_relative_position_index(self.window)).to(self.device)
        self._region_masks: dict = {}
        self.module_names = tuple(self._enumerate_module_names())

    # ------------------------------------------------------------------ names
    def _enumerate_module_names(self):
        names = ["features", "features.0", "features.0.0", "features.0.1", "features.0.2"]
        fi = 1
        for stage, depth in enumerate(self.depths):
            base = f"features.{fi}"
            names.append(base)
            for b in range(depth):
                # ``attn.qkv`` / ``attn.proj`` are absent: torchvision calls them functionally (its hooks never
                # fire), and their windowed (B·nW, T, C) values would break the batch-leading tap contract.
                blk = f"{base}.{b}"
                names += [blk, f"{blk}.norm1", f"{blk}.attn", f"{blk}.stochastic_depth", f"{blk}.norm2",
                          f"{blk}.mlp"] + [f"{blk}.mlp.{i}" for i in range(5)]
            fi += 1
            if stage < len(self.depths) - 1:
                names += [f"features.{fi}", f"features.{fi}.reduction", f"features.{fi}.norm"]
                fi += 1
        names += ["norm", "permute", "avgpool", "flatten"]
        return names + (["head"] if self.num_classes else [])

    # ------------------------------------------------------------------ params
    @staticmethod
    def _ln_specs(prefix, ch):
        return [(f"{prefix}.weight", (ch,), "ones"), (f"{prefix}.bias", (ch,), "zeros")]

    def _attn_specs(self, blk, dim, heads):
        return [(f"{blk}.attn.relative_position_bias_table", ((2 * _WINDOW - 1) ** 2, heads), "zeros")]

    def _merge_norm_width(self, dim):
        return 4 * dim

    def _param_specs(self):
        d = self.embed_dim
        specs = [("features.0.0.weight", (_PATCH, _PATCH, 3, d), "conv"), ("features.0.0.bias", (d,), "zeros")]
        specs += self._ln_specs("features.0.2", d)
        fi = 1
        for stage, depth in enumerate(self.depths):
            dim, heads = d * 2**stage, self.heads[stage]
            for b in range(depth):
                blk = f"features.{fi}.{b}"
                specs += self._ln_specs(f"{blk}.norm1", dim)
                specs += [(f"{blk}.attn.qkv.weight", (dim, 3 * dim), "linear"),
                          (f"{blk}.attn.qkv.bias", (3 * dim,), "zeros"),
                          (f"{blk}.attn.proj.weight", (dim, dim), "linear"),
                          (f"{blk}.attn.proj.bias", (dim,), "zeros")]
                specs += self._attn_specs(blk, dim, heads)
                specs += self._ln_specs(f"{blk}.norm2", dim)
                specs += [(f"{blk}.mlp.0.weight", (dim, _MLP_RATIO * dim), "linear"),
                          (f"{blk}.mlp.0.bias", (_MLP_RATIO * dim,), "zeros"),
                          (f"{blk}.mlp.3.weight", (_MLP_RATIO * dim, dim), "linear"),
                          (f"{blk}.mlp.3.bias", (dim,), "zeros")]
            fi += 1
            if stage < len(self.depths) - 1:
                merge = f"features.{fi}"
                specs += [(f"{merge}.reduction.weight", (4 * dim, 2 * dim), "linear")]
                specs += self._ln_specs(f"{merge}.norm", self._merge_norm_width(dim))
                fi += 1
        specs += self._ln_specs("norm", self.num_features)
        if self.num_classes:
            specs += [("head.weight", (self.num_features, self.num_classes), "linear"),
                      ("head.bias", (self.num_classes,), "zeros")]
        return specs

    def _draw(self, name, shape, kind):
        """Normal(0, 0.02) linears, patch conv and bias tables (torchvision's trunc_normal(0.02), untruncated),
        unit LayerNorms: the JAX package's scheme."""
        if kind in ("conv", "linear") or name.endswith("relative_position_bias_table"):
            return "normal", 0.02
        return "const", 1.0 if kind == "ones" else 0.0

    # ------------------------------------------------------------------ forward
    def _ln(self, params, prefix, x):
        return layer_norm(x, params[f"{prefix}.weight"], params[f"{prefix}.bias"], eps=self.LN_EPS)

    def _region_mask(self, ph, pw, sh, sw, device):
        """(nW, 1, T, T) float32 shifted-window mask on ``device``, built once per geometry."""
        key = (ph, pw, sh, sw, device)
        if key not in self._region_masks:
            mask = _shift_region_mask(ph, pw, self.window, sh, sw)
            self._region_masks[key] = torch.from_numpy(mask)[:, None].to(device)
        return self._region_masks[key]

    def _position_bias(self, params, blk, heads):
        """(H, T, T) float32 relative-position bias of one block."""
        t = self.window**2
        table = params[f"{blk}.attn.relative_position_bias_table"].float()
        return table[self._rel_index].reshape(t, t, heads).permute(2, 0, 1)

    def _qk(self, params, blk, q, k, heads):
        """Queries and keys as the attention helper takes them (V2 normalises them)."""
        return q, k

    def _window_attention(self, params, x, blk, heads, shift, tap):
        """torchvision ``shifted_window_attention`` (V2: ``_v2``), (B, H, W, C) in and out."""
        b, h, w, c = x.shape
        ws = self.window
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        ph, pw = h + pad_b, w + pad_r
        sh, sw = (0 if ws >= ph else shift), (0 if ws >= pw else shift)
        if sh or sw:
            x = torch.roll(x, (-sh, -sw), dims=(1, 2))
        nh, nw, t = ph // ws, pw // ws, ws * ws
        xw = x.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b * nh * nw, t, c)

        qkv = linear(xw, params[f"{blk}.attn.qkv.weight"], params[f"{blk}.attn.qkv.bias"])
        q, k = self._qk(params, blk, qkv[..., :c], qkv[..., c:2 * c], heads)
        bias = self._position_bias(params, blk, heads)[None]  # (1, H, T, T)
        if sh or sw:
            bias = bias + self._region_mask(ph, pw, sh, sw, bias.device)  # (nW, H, T, T): period nW over the batch
        out = scaled_dot_product_attention(q, k, qkv[..., 2 * c:], heads, mask=bias, float32_mask=True)
        out = linear(out, params[f"{blk}.attn.proj.weight"], params[f"{blk}.attn.proj.bias"])

        out = out.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, ph, pw, c)
        if sh or sw:
            out = torch.roll(out, (sh, sw), dims=(1, 2))
        if pad_b or pad_r:
            out = out[:, :h, :w]
        return tap(f"{blk}.attn", out)

    def _mlp(self, params, x, blk, tap):
        m = tap(f"{blk}.mlp.0", linear(x, params[f"{blk}.mlp.0.weight"], params[f"{blk}.mlp.0.bias"]))
        m = tap(f"{blk}.mlp.2", tap(f"{blk}.mlp.1", gelu(m)))  # mlp.2: inference-identity Dropout
        m = tap(f"{blk}.mlp.3", linear(m, params[f"{blk}.mlp.3.weight"], params[f"{blk}.mlp.3.bias"]))
        return tap(f"{blk}.mlp", tap(f"{blk}.mlp.4", m))  # mlp.4: inference-identity Dropout

    def _block(self, params, x, blk, heads, shift, tap):
        h = self._window_attention(params, tap(f"{blk}.norm1", self._ln(params, f"{blk}.norm1", x)), blk, heads,
                                   shift, tap)
        # torchvision applies one StochasticDepth module to both branches (identity at inference): the last
        # tap wins, as for any module called twice.
        x = residual_add(x, tap(f"{blk}.stochastic_depth", h))
        m = self._mlp(params, tap(f"{blk}.norm2", self._ln(params, f"{blk}.norm2", x)), blk, tap)
        return tap(blk, residual_add(x, tap(f"{blk}.stochastic_depth", m)))

    @staticmethod
    def _parities(x):
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        return torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)

    def _patch_merge(self, params, x, merge, tap):
        x = tap(f"{merge}.norm", self._ln(params, f"{merge}.norm", self._parities(x)))
        return tap(merge, tap(f"{merge}.reduction", linear(x, params[f"{merge}.reduction.weight"])))

    def apply(self, params: Mapping, x, tap_names: Sequence[str] = ()):
        """(B, H, W, 3) float → (logits, taps). Taps are (B, H', W', C)."""
        tap = TapCollector(tap_names)
        x = conv2d(x.permute(0, 3, 1, 2).to(self.dtype), params["features.0.0.weight"], params["features.0.0.bias"],
                   stride=_PATCH)
        x = tap("features.0.0", x.permute(0, 2, 3, 1))
        x = tap("features.0.1", x)  # torchvision's Permute: the layout is already (B, H, W, C)
        x = tap("features.0", tap("features.0.2", self._ln(params, "features.0.2", x)))
        fi = 1
        for stage, depth in enumerate(self.depths):
            for b in range(depth):
                x = self._block(params, x, f"features.{fi}.{b}", self.heads[stage], 0 if b % 2 == 0 else self.window // 2,
                                tap)
            x = tap(f"features.{fi}", x)
            fi += 1
            if stage < len(self.depths) - 1:
                x = self._patch_merge(params, x, f"features.{fi}", tap)
                fi += 1
        x = tap("features", x)
        x = tap("permute", tap("norm", self._ln(params, "norm", x)))  # torchvision's Permute to NCHW: stays BHWC
        x = tap("flatten", tap("avgpool", torch.mean(x, dim=(1, 2))))
        if self.num_classes:
            x = tap("head", linear(x, params["head.weight"], params["head.bias"]))
        return x, tap.taps

    def __repr__(self):
        return f"{type(self).__name__}(variant={self.variant!r}, num_classes={self.num_classes})"


class SwinTransformerV2(SwinTransformer):
    """Swin-V2-T/S/B with torchvision-compatible names (post-norm, cosine attention, continuous position bias,
    window 8)."""

    window = 8
    _CPB_HIDDEN = 512

    def __init__(self, variant: str = "tiny", num_classes: int = 1000, *, dtype=torch.bfloat16, device=None):
        super().__init__(variant, num_classes, dtype=dtype, device=device)
        self._cpb_table = torch.from_numpy(_relative_coords_table(self.window).astype(np.float32)).to(self.device)

    def _attn_specs(self, blk, dim, heads):
        return [(f"{blk}.attn.logit_scale", (heads, 1, 1), "logit_scale"),
                (f"{blk}.attn.cpb_mlp.0.weight", (2, self._CPB_HIDDEN), "linear"),
                (f"{blk}.attn.cpb_mlp.0.bias", (self._CPB_HIDDEN,), "zeros"),
                (f"{blk}.attn.cpb_mlp.2.weight", (self._CPB_HIDDEN, heads), "linear")]

    def _merge_norm_width(self, dim):
        return 2 * dim  # V2: LN(2C) after the reduction

    def _draw(self, name, shape, kind):
        """Normal(0, 0.02) linears and patch conv, ``logit_scale`` log 10, unit LayerNorms: the JAX scheme."""
        if kind == "logit_scale":
            return "const", math.log(10.0)
        if kind in ("conv", "linear"):
            return "normal", 0.02
        return "const", 1.0 if kind == "ones" else 0.0

    def _position_bias(self, params, blk, heads):
        """``16·sigmoid`` of the CPB MLP over the log-spaced coordinates, (H, T, T) float32.

        Plain float32 ops, as the JAX package's: no LRP rule (the bias is a
        constant of CP-LRP).
        """
        t = self.window**2
        p = f"{blk}.attn.cpb_mlp"
        hidden = torch.relu(F.linear(self._cpb_table, params[f"{p}.0.weight"].float(), params[f"{p}.0.bias"].float()))
        cpb = F.linear(hidden, params[f"{p}.2.weight"].float())  # ((2ws−1)², heads)
        return (16.0 * torch.sigmoid(cpb[self._rel_index].reshape(t, t, heads))).permute(2, 0, 1)

    def _qk(self, params, blk, q, k, heads):
        """Cosine attention folded into the helper: q and k normalised per head in float32, q pre-scaled by
        ``exp(min(logit_scale, log 100))·√hd`` so that the helper's 1/√hd cancels."""
        bw, t, c = q.shape
        hd = c // heads

        def unit(z):
            z = z.reshape(bw, t, heads, hd).float()
            return z / torch.clamp_min(torch.linalg.vector_norm(z, dim=-1, keepdim=True), 1e-12)

        scale = torch.exp(torch.clamp_max(params[f"{blk}.attn.logit_scale"].float(), math.log(100.0)))  # (H, 1, 1)
        qn = unit(q) * (scale[:, 0, 0] * math.sqrt(hd))[None, None, :, None]
        return qn.reshape(bw, t, c).to(q.dtype), unit(k).reshape(bw, t, c).to(k.dtype)

    def _block(self, params, x, blk, heads, shift, tap):
        # post-norm: the norm after each branch, the residual outside
        h = self._window_attention(params, x, blk, heads, shift, tap)
        h = tap(f"{blk}.norm1", self._ln(params, f"{blk}.norm1", h))
        x = residual_add(x, tap(f"{blk}.stochastic_depth", h))
        m = self._mlp(params, x, blk, tap)
        m = tap(f"{blk}.norm2", self._ln(params, f"{blk}.norm2", m))
        return tap(blk, residual_add(x, tap(f"{blk}.stochastic_depth", m)))

    def _patch_merge(self, params, x, merge, tap):
        x = tap(f"{merge}.reduction", linear(self._parities(x), params[f"{merge}.reduction.weight"]))
        return tap(merge, tap(f"{merge}.norm", self._ln(params, f"{merge}.norm", x)))
