"""Plain float32 operations of the references, with an optional int8 rounding of matmul operands.

Everything here is written from the published definitions in plain
PyTorch: no kernel, cache or batching of the program under test. The
float32 matmuls and convolutions run without TF32 (``strict_float32``),
so the reference computes in float32 on the card as it does on the CPU.

``quant="int8"`` rounds both operands of every linear layer and
convolution to symmetric int8 before the float32 product: weights per
output channel, activations per row (per sample for a convolution). That
is the control of a bfloat16 configuration: the reference put in the
program's place one precision step below the stated one.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def strict_float32():
    """float32 matmuls and convolutions without TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def int8_round(x: torch.Tensor, dims) -> torch.Tensor:
    """Symmetric int8 rounding of ``x`` with one scale per slice over ``dims`` (the amax maps to 127)."""
    scale = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30) / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


def linear(x, weight, bias=None, quant=None):
    """``x @ weight.T + bias``; weight (out, in)."""
    if quant == "int8":
        x = int8_round(x, -1)
        weight = int8_round(weight, -1)
    out = x @ weight.t()
    return out if bias is None else out + bias


def conv2d(x, weight, bias=None, *, stride=1, padding=0, quant=None):
    """NCHW convolution, OIHW weight."""
    if quant == "int8":
        x = int8_round(x, (1, 2, 3))
        weight = int8_round(weight, (1, 2, 3))
    return F.conv2d(x, weight, bias, stride=stride, padding=padding)


def batch_norm(x, weight, bias, mean, var, eps=1e-5):
    """Inference batch norm over dim 1 of NCHW: (x − mean) / sqrt(var + eps) · weight + bias."""
    shape = (1, -1, 1, 1)
    return (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + eps) * weight.view(shape) + bias.view(shape)


def layer_norm(x, weight, bias, eps):
    """LayerNorm over the last axis, population variance."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * weight + bias


def gelu(x):
    """Exact GELU: x · Φ(x)."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def quick_gelu(x):
    """OpenAI CLIP's x · σ(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def attention(q, k, v, heads: int):
    """Multi-head softmax attention: (B, T, D) q, (B, S, D) k and v → (B, T, D); heads split the last axis."""
    b, t, d = q.shape
    s = k.shape[1]
    hd = d // heads
    q = q.reshape(b, t, heads, hd).transpose(1, 2)
    k = k.reshape(b, s, heads, hd).transpose(1, 2)
    v = v.reshape(b, s, heads, hd).transpose(1, 2)
    probs = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    return (probs @ v).transpose(1, 2).reshape(b, t, d)
