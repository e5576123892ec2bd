"""Functional forward primitives (counterpart of ``semanticlens_tpu.models.layers``).

Everything is a plain function of tensors and a flat parameter dict with
torch names, like the JAX package — but in torch's own layouts: activations
NCHW (channels_last memory on the card, which cuDNN prefers), conv weights
OIHW, linear weights (out, in). ``convert.py`` relayouts the JAX package's
HWIO / (in, out) parameters into these.

Dtype policy follows the JAX package: convs and matmuls run in the
activation dtype (bf16 on the card, float32 accumulation inside
cuDNN/cuBLAS); normalisation statistics are computed in float32 and cast
back. The LRP rules of the JAX layers are not ported here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x, weight, bias=None, *, stride=1, padding=0, groups=1):
    """2-D convolution: NCHW input, OIHW weight, torch-style int padding."""
    out = F.conv2d(x, weight.to(x.dtype), None, stride=stride, padding=padding, groups=groups)
    if bias is not None:
        out = out + bias.to(out.dtype).view(1, -1, 1, 1)
    return out


def batch_norm(x, weight, bias, running_mean, running_var, *, eps=1e-5):
    """Inference-mode batch norm over the channel axis (dim 1) of NCHW ``x``.

    One fused pass (``F.batch_norm``: statistics and affine in float32, one
    rounding to ``x.dtype``). The JAX package rounds scale and shift to
    ``x.dtype`` and rounds again after the multiply; in bf16 the two differ
    by at most one rounding step, in float32 only in the last bits. Written
    as ``x * scale + shift`` the fold takes two broadcast passes, which run
    at a fraction of the memory rate on channels_last tensors (PERF.md).
    """
    return F.batch_norm(x, running_mean.float(), running_var.float(), weight.float(), bias.float(),
                        training=False, eps=eps)


def linear(x, weight, bias=None):
    """Dense layer; ``weight`` is torch's (out, in)."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def max_pool(x, *, window=3, stride=2, padding=1, ceil_mode=False):
    """Max pooling over NCHW, −inf padding (torch semantics, incl. ceil_mode)."""
    return F.max_pool2d(x, window, stride, padding, ceil_mode=ceil_mode)


def avg_pool(x, *, window=2, stride=2, padding=0):
    """Average pooling over NCHW (zero padding counted, as the JAX package's ``reduce_window`` sum).

    torch sums a bf16 input in float32 and rounds the mean once, as the JAX
    package does by casting to float32 around the sum.
    """
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=True)


def global_avg_pool(x):
    """(B, C, H, W) → (B, C, 1, 1) adaptive average pool to 1×1."""
    return torch.mean(x, dim=(2, 3), keepdim=True)


def layer_norm(x, weight, bias, *, eps=1e-5):
    """LayerNorm over the last axis, computed in float32, cast back to ``x.dtype``."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def quick_gelu(x):
    """x·sigmoid(1.702x) — OpenAI CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x, *, approximate=False):
    """GELU, exact (erf) or tanh-approximate."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def multi_head_attention(x, params, prefix, n_heads, *, mask=None, kv=None):
    """Torch-style ``nn.MultiheadAttention`` with fused in-proj weights.

    Params: ``{prefix}.in_proj_weight`` (3D, D), ``{prefix}.in_proj_bias``
    (3D,), ``{prefix}.out_proj.weight`` (D, D), ``{prefix}.out_proj.bias``.
    x: (B, T, D) queries; kv: optional (B, S, D) keys/values (defaults to x).
    mask: optional additive (T, S) float mask.
    """
    d_model = x.shape[-1]
    w_in = params[f"{prefix}.in_proj_weight"]
    b_in = params[f"{prefix}.in_proj_bias"]
    if kv is None:
        # Self-attention: one (D, 3D) projection, then slice.
        q, k, v = linear(x, w_in, b_in).split(d_model, dim=-1)
    else:
        q = linear(x, w_in[:d_model], b_in[:d_model])
        k = linear(kv, w_in[d_model : 2 * d_model], b_in[d_model : 2 * d_model])
        v = linear(kv, w_in[2 * d_model :], b_in[2 * d_model :])
    out = scaled_dot_product_attention(q, k, v, n_heads, mask=mask)
    return linear(out, params[f"{prefix}.out_proj.weight"], params[f"{prefix}.out_proj.bias"])


def scaled_dot_product_attention(q, k, v, n_heads, *, mask=None, scale=None):
    """Batched MHA core: (B, T, D) q / (B, S, D) k, v → (B, T, D).

    ``mask`` is additive (−inf blocks), shaped (T, S). Runs through
    ``F.scaled_dot_product_attention`` (the flash or memory-efficient backend
    on the card), as the JAX package leaves attention to XLA.
    """
    b, t, d = q.shape
    s = k.shape[1]
    head_dim = d // n_heads

    def split(z, length):
        return z.reshape(b, length, n_heads, head_dim).transpose(1, 2)

    attn_mask = None if mask is None else mask.to(q.dtype)
    out = F.scaled_dot_product_attention(
        split(q, t), split(k, s), split(v, s), attn_mask=attn_mask, scale=scale
    )
    return out.transpose(1, 2).reshape(b, t, d)
