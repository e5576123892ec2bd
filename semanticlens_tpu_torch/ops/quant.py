"""Int8 weights and activations for the towers' matmuls and convs (W8A8, dynamic).

Counterpart of ``semanticlens_tpu.ops.quant``, in the port's layouts: dense
weights are torch's ``(out, in)`` and conv weights OIHW, so the OUT channel
is dim 0 here (the last axis in the JAX package).

- **weights**: static symmetric per-output-channel int8 (scale = channel
  absmax / 127), quantized once when the model is built;
- **activations**: dynamic symmetric int8, quantized right before each
  product (per row for a dense layer, per sample for a conv, whose output
  sums positions of one sample, so only a per-sample scale factors out of
  it);
- **the product**: int8 × int8 → int32 by ``torch._int_mm`` (cuBLASLt's
  int8 GEMM on the card; a convolution goes through an int8 im2col first,
  torch having no int8 convolution on CUDA), then both scales applied to
  the int32 accumulator in float32.

Every step is the JAX module's, in its order (divide, round half to even,
clip to ±127), so ``x_q`` and the int32 accumulators equal the JAX ones
exactly on the CPU, and the card's equal the CPU's. Everything else in a
tower (norms, softmax, residual adds, embeddings, the final projection)
stays in its float dtype. Int8 is opt-in: it changes embeddings within
quantization noise (cosine ≥ 0.995 against the float tower), so caches of
a quantized tower carry ``-int8`` in their key.

``models.layers.linear`` and ``conv2d`` take a :class:`QuantizedTensor`
weight; under an LRP composite they dequantize it and take the float rule
path, so attribution never sees quantization rounding.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

# torch._int_mm's shape rules on CUDA (cuBLASLt int8 GEMM): more than 16
# rows, K and N multiples of 8. ``int_mm`` pads to them with zeros, which
# leaves the int32 product exact; the CPU takes the same padded path.
_MIN_ROWS = 17
_ALIGN = 8


class QuantizedTensor(NamedTuple):
    """An int8 weight with per-out-channel float32 scales; out channel on dim 0.

    ``q`` is ``(out, in)`` for a dense layer, ``(out, in/groups, kh, kw)``
    for a conv, contiguous; ``scale`` is ``(out,)``.
    """

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def in_features(self) -> int:
        return self.q.shape[1]

    @property
    def out_features(self) -> int:
        return self.q.shape[0]

    def to(self, device) -> "QuantizedTensor":
        """Both tensors on ``device`` (dtypes kept)."""
        return QuantizedTensor(self.q.to(device), self.scale.to(device))


def _round_clip_int8(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), ±127)`` as int8: a division (not a reciprocal product), half to even."""
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)


def _scale_of(absmax: torch.Tensor) -> torch.Tensor:
    """``absmax / 127`` (1 where absmax is 0). The divisor is a tensor on ``absmax``'s device: torch's CUDA
    division by a Python scalar multiplies by its reciprocal, which rounds differently from the CPU's (and
    the JAX package's) true division in about 5% of the scales."""
    return torch.where(absmax > 0, absmax / absmax.new_full((), 127.0), torch.ones_like(absmax))


def quantize_weight(w: torch.Tensor) -> QuantizedTensor:
    """Float weight (out channel on dim 0, any rank ≥ 2) → symmetric per-out-channel int8.

    ``scale[o] = absmax(w[o]) / 127``; zero channels get scale 1 (their
    int8 values are all zero). A DTensor is gathered whole first.
    """
    if hasattr(w, "full_tensor"):
        w = w.full_tensor()
    w32 = w.detach().float()
    absmax = w32.abs().amax(dim=tuple(range(1, w32.ndim)))
    scale = _scale_of(absmax)
    q = _round_clip_int8(w32, scale.view(-1, *([1] * (w32.ndim - 1))))
    return QuantizedTensor(q=q.contiguous(), scale=scale.contiguous())


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    """The int8 weight back in float32: ``q · scale`` over dim 0 (the LRP path)."""
    return qt.q.float() * qt.scale.view(-1, *([1] * (qt.q.ndim - 1)))


def col_slice(w, start: int, stop: int):
    """Out-channels ``start:stop`` of a weight that may be quantized.

    The JAX name, kept for findability: there the out channels are the
    columns of an ``(in, out)`` weight; here they are dim 0, the rows of
    ``(out, in)``, so this slices ``q[start:stop]`` and
    ``scale[start:stop]``. Per-out-channel scales make the slice exact
    (``multi_head_attention`` splits a fused in-proj into Q, K and V).
    """
    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(q=w.q[start:stop], scale=w.scale[start:stop])
    return w[start:stop]


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ wᵀ`` in int32 for int8 ``a`` (M, K) and ``w`` (N, K), by ``torch._int_mm``.

    Rows, K and N are zero-padded to ``_int_mm``'s CUDA shape rules (exact
    in int32) and the padding is cut off the result. ``w`` contiguous
    ``(N, K)`` makes ``w.t()`` the column-major B of cuBLASLt's "TN" int8
    GEMM.
    """
    m, k = a.shape
    n = w.shape[0]
    mp = max(m, _MIN_ROWS)
    kp = -(-k // _ALIGN) * _ALIGN
    np_ = -(-n // _ALIGN) * _ALIGN
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out if (mp, np_) == (m, n) else out[:m, :n]


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row int8 of ``x`` (..., K): ``(x_q, x_scale)``, ``x_scale`` (..., 1) float32."""
    x32 = x.float()
    x_scale = _scale_of(x32.abs().amax(dim=-1, keepdim=True))
    return _round_clip_int8(x32, x_scale), x_scale


def int8_matmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """(..., in) float @ QuantizedTensor ``(out, in)`` → (..., out) in ``x.dtype``.

    Rows quantized dynamically (absmax / 127, all-zero rows scale 1, so
    they stay exactly zero), an int32 product, then
    ``acc · x_scale · scale`` in float32.
    """
    x_q, x_scale = quantize_rows(x)
    acc = int_mm(x_q.reshape(-1, x_q.shape[-1]), qt.q)
    out = acc.float().view(*x.shape[:-1], qt.out_features) * x_scale * qt.scale
    return out.to(x.dtype)


def quantize_samples(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-sample int8 of NCHW ``x``: ``(x_q, x_scale)``, ``x_scale`` (N, 1, 1, 1) float32.

    ``x_q`` keeps ``x``'s memory format (channels_last stays channels_last).
    """
    x32 = x.float()
    x_scale = _scale_of(x32.abs().amax(dim=(1, 2, 3), keepdim=True))
    return _round_clip_int8(x32, x_scale), x_scale


def im2col(x_q: torch.Tensor, kh: int, kw: int, *, stride=1, padding=0) -> torch.Tensor:
    """The (N, Ho, Wo, C, kh, kw) patches of int8 NCHW ``x_q``, a view where it can be.

    Built on the NHWC view (free for channels_last): zero padding in int8,
    then ``unfold`` over H and W, whose ``(C, kh, kw)`` order is
    ``q.view(O, -1)``'s. A 1×1 conv takes the strided NHWC view itself.
    """
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    xn = x_q.permute(0, 2, 3, 1)
    if ph or pw:
        xn = F.pad(xn, (0, 0, pw, pw, ph, ph))
    if kh == kw == 1:
        return xn[:, ::sh, ::sw, :, None, None]
    return xn.unfold(1, kh, sh).unfold(2, kw, sw)


def int8_conv_acc(x_q: torch.Tensor, q: torch.Tensor, *, stride=1, padding=0, groups: int = 1) -> torch.Tensor:
    """The int32 convolution of int8 NCHW ``x_q`` with int8 OIHW ``q``, as (N, Ho, Wo, O).

    Each group's :func:`im2col` columns, (N·Ho·Wo, C/groups·kh·kw) (a copy,
    or a view for a contiguous 1×1), times its rows of ``q`` by
    :func:`int_mm`; groups run one after the other.
    """
    o, cg, kh, kw = q.shape
    cols = im2col(x_q, kh, kw, stride=stride, padding=padding)
    n, ho, wo = cols.shape[:3]
    og = o // groups
    accs = [int_mm(cols[:, :, :, g * cg:(g + 1) * cg].reshape(n * ho * wo, cg * kh * kw),
                   q[g * og:(g + 1) * og].reshape(og, -1)) for g in range(groups)]
    acc = accs[0] if groups == 1 else torch.cat(accs, dim=1)
    return acc.view(n, ho, wo, o)


def int8_conv(x: torch.Tensor, qt: QuantizedTensor, *, stride=1, padding=0, groups: int = 1) -> torch.Tensor:
    """NCHW float ``x`` convolved with an OIHW :class:`QuantizedTensor` → NCHW in ``x.dtype``.

    Per-sample activation scales (absmax over C·H·W), an int32 im2col
    product, then ``acc · x_scale · scale`` in float32. The result is an
    NCHW view of NHWC memory, i.e. channels_last.
    """
    x_q, x_scale = quantize_samples(x)
    acc = int8_conv_acc(x_q, qt.q, stride=stride, padding=padding, groups=groups)
    out = acc.float() * x_scale.view(-1, 1, 1, 1) * qt.scale
    return out.to(x.dtype).permute(0, 3, 1, 2)


def quantize_params(params: dict, match: Callable[[str], bool]) -> dict:
    """``params`` with every float weight whose key satisfies ``match`` replaced by a :class:`QuantizedTensor`.

    Only rank-2 ``(out, in)`` dense and rank-4 OIHW conv weights qualify;
    matching anything else raises, since a silent reshape would corrupt a
    tower.
    """
    out = {}
    for key, value in params.items():
        if match(key) and not isinstance(value, QuantizedTensor):
            if value.ndim not in (2, 4):
                raise ValueError(
                    f"quantize_params matched {key!r} with rank {value.ndim}; only rank-2 (out, in) dense and "
                    "rank-4 OIHW conv weights can be int8-quantized")
            out[key] = quantize_weight(value)
        else:
            out[key] = value
    return out


#: Key suffixes of the transformer dense weights worth quantizing: the QKV
#: and out projections and the MLP pair, almost all of a ViT or text
#: tower's FLOPs. LayerNorms, biases, embeddings, convs and the final
#: projection stay float.
TRANSFORMER_DENSE_SUFFIXES = (
    ".attn.in_proj_weight",
    ".attn.out_proj.weight",
    ".mlp.c_fc.weight",
    ".mlp.c_proj.weight",
)


def transformer_dense_match(prefix: str = "") -> Callable[[str], bool]:
    """Predicate selecting the transformer matmul weights under ``prefix``."""

    def match(key: str) -> bool:
        return key.startswith(prefix) and key.endswith(TRANSFORMER_DENSE_SUFFIXES)

    return match
