"""Fused cosine-similarity matrix: the hand-written CUDA kernel K1 and its plain version.

Replaces the one TPU kernel of the JAX package,
``semanticlens_tpu/ops/pallas_ops.py: cosine_similarity_matrix``. The CUDA
source is ``csrc/cosine.cu`` (design, and what bounds it, are noted there):
fp32 FMA — not TF32 — because the reference contracts at
``Precision.HIGHEST`` and its tests hold atol 2e-5/3e-5.

A CPU tensor takes :func:`cosine_similarity_matrix_plain`; a CUDA tensor
launches the kernel or raises. ``cosine_similarity_matrix.launches`` counts
kernel launches (never plain-version calls), so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

_EPS = 1e-24


def cosine_similarity_matrix_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(x @ yᵀ) · rsqrt(‖x‖²+ε) · rsqrt(‖y‖²+ε)`` in float32; (..., M, D) × (..., N, D)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    dots = torch.matmul(x, y.transpose(-1, -2))
    x_inv = torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + _EPS)
    y_inv = torch.rsqrt(torch.sum(y * y, dim=-1) + _EPS).unsqueeze(-2)
    return dots * x_inv * y_inv


def _kernel_fn():
    from semanticlens_tpu_torch.utils import cuda_build

    lib = cuda_build.load("cosine")
    fn = lib.cosine_similarity_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_int32(name: str, value: int):
    if value > 2**31 - 1:
        raise ValueError(f"{name}={value} exceeds the kernel's int32 range")


def cosine_similarity_matrix_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch K1 on CUDA tensors: (..., M, D) × (..., N, D) → (..., M, N) float32.

    Leading dimensions must match (they become the kernel's batch grid axis).
    """
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"K1 needs both operands on one CUDA device, got {x.device} and {y.device}")
    if x.ndim < 2 or x.ndim != y.ndim or x.shape[:-2] != y.shape[:-2] or x.shape[-1] != y.shape[-1]:
        raise ValueError(f"K1 takes (..., M, D) and (..., N, D) with equal leading dims, "
                         f"got {tuple(x.shape)} and {tuple(y.shape)}")
    lead = x.shape[:-2]
    m, d = x.shape[-2:]
    n = y.shape[-2]
    xc = x.to(torch.float32).contiguous().reshape(-1, m, d)
    yc = y.to(torch.float32).contiguous().reshape(-1, n, d)
    batch = xc.shape[0]
    for name, v in (("batch", batch), ("M", m), ("N", n), ("D", d)):
        _check_int32(name, v)
    out = torch.empty((batch, m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out.reshape(*lead, m, n)
    fn = _kernel_fn()
    err = fn(xc.data_ptr(), yc.data_ptr(), out.data_ptr(), batch, m, n, d, m * d, n * d,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cosine kernel launch failed: cudaError {err}")
    cosine_similarity_matrix.launches += 1
    return out.reshape(*lead, m, n)


def cosine_similarity_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Fused ``x̂ @ ŷᵀ`` for (..., M, D) × (..., N, D) → (..., M, N) float32.

    Zero rows give 0 similarity. CPU tensors take the plain version; CUDA
    tensors launch the kernel (no fallback).
    """
    if x.device.type == "cpu" and y.device.type == "cpu":
        return cosine_similarity_matrix_plain(x, y)
    return cosine_similarity_matrix_cuda(x, y)


cosine_similarity_matrix.launches = 0
