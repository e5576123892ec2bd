"""Fused cosine-similarity matrix: the hand-written CUDA kernel K1 and its plain version.

Replaces the one TPU kernel of the JAX package,
``semanticlens_tpu/ops/pallas_ops.py: cosine_similarity_matrix``. The CUDA
source is ``csrc/cosine.cu`` (design, and what bounds each kernel, are noted
there). It holds two kernels behind one entry point, chosen by
:func:`plan_launch`:

- **streaming** (M ≤ ``STREAMING_MAX_M``: text probing): bound by the bytes
  of y; exact fp32 FMA on the CUDA cores, x staged once per block in shared
  memory, y streamed with 16-byte loads. The kernel picks its compiled M
  bound and its grid (two blocks per SM) itself.
- **tiled** (larger M: redundancy): bound by arithmetic; 3×TF32 on the
  tensor cores (``wgmma``, operands split into TF32 big and small halves,
  three products summed in fp32), fed by TMA, with the tensor cores'
  partial sums flushed to a rounded-to-nearest sum every 512 of D. That
  holds the reference's ``Precision.HIGHEST`` tolerance (atol 3e-5) at any
  D; a single TF32 pass does not (tests/test_torch_cosine.py).

Both need D to be a multiple of 4 (16-byte rows for TMA and vector loads):
the wrapper pads D with zeros, which changes neither dots nor norms.

A CPU tensor takes :func:`cosine_similarity_matrix_plain`; a CUDA tensor
launches one of the two kernels or raises. Each variant counts its launches
in the tracer's counters ``k1.launches.streaming`` and ``k1.launches.tiled``
(never plain-version calls; ``launch_counts()`` reads them), so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from semanticlens_tpu_torch.utils.profiling import count, counters, reset

_EPS = 1e-24

# The streaming kernel serves M ≤ STREAMING_MAX_M (the largest M it is
# compiled for) with M·N ≤ STREAMING_MAX_MN, and x no larger than
# STREAMING_MAX_X_BYTES (staged in shared memory by every block). Its time
# grows with M·N (CUDA-core FMAs fed from shared memory); the tiled kernel's
# stays flat until its grid fills the card. sweep_k1.py's threshold sweep
# over M and N is the measurement behind these numbers.
STREAMING_MAX_M = 32
STREAMING_MAX_MN = 2**16
STREAMING_MAX_X_BYTES = 160 * 1024
# Tiles of cosine.cu's tiled kernel: config id → (block rows, block cols).
TILE_CONFIGS = {0: (128, 256), 1: (64, 128)}
_INT32_MAX = 2**31 - 1


def cosine_similarity_matrix_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(x @ yᵀ) · rsqrt(‖x‖²+ε) · rsqrt(‖y‖²+ε)`` in float32; (..., M, D) × (..., N, D)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    dots = torch.matmul(x, y.transpose(-1, -2))
    x_inv = torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + _EPS)
    y_inv = torch.rsqrt(torch.sum(y * y, dim=-1) + _EPS).unsqueeze(-2)
    return dots * x_inv * y_inv


@dataclass(frozen=True)
class LaunchPlan:
    """Which kernel a (batch, M, N, D) problem takes, and how it is launched."""

    variant: str  # "streaming" or "tiled"
    d_pad: int  # D rounded up to a multiple of 4
    config: int = -1  # tiled: key of TILE_CONFIGS


def _tiled_config(m: int, n: int, num_sms: int) -> int:
    """The tile that finishes first: fewest tile-areas on the busiest SM, then the largest tile."""

    def cost(cfg):
        bm, bn = TILE_CONFIGS[cfg]
        tiles = math.ceil(m / bm) * math.ceil(n / bn)
        return math.ceil(tiles / num_sms) * bm * bn, -bm * bn

    return min(TILE_CONFIGS, key=cost)


def plan_launch(batch: int, m: int, n: int, d: int, num_sms: int) -> LaunchPlan:
    """The launch of K1 for (batch, M, D) × (batch, N, D) on a card with ``num_sms`` SMs."""
    for name, v in (("batch", batch), ("M", m), ("N", n), ("D", d)):
        if v > _INT32_MAX:
            raise ValueError(f"{name}={v} exceeds the kernel's int32 range")
    if batch > 65535:
        raise ValueError(f"batch={batch} exceeds the kernel's grid limit of 65535")
    d_pad = -(-d // 4) * 4
    if m <= STREAMING_MAX_M and m * n <= STREAMING_MAX_MN and m * d_pad * 4 <= STREAMING_MAX_X_BYTES:
        return LaunchPlan("streaming", d_pad)
    config = _tiled_config(m, n, num_sms)
    if math.ceil(m / TILE_CONFIGS[config][0]) > 65535:
        raise ValueError(f"M={m} exceeds the tiled kernel's grid limit")
    return LaunchPlan("tiled", d_pad, config=config)


def pad_features(a: torch.Tensor, d_pad: int) -> torch.Tensor:
    """Zero-pad the last axis to ``d_pad``: dots and norms are unchanged."""
    return a if a.shape[-1] == d_pad else F.pad(a, (0, d_pad - a.shape[-1]))


@functools.lru_cache(maxsize=None)
def _num_sms(device_index: int) -> int:
    """The card's SM count, read once: the CUDA query behind it takes ~20 ms on a
    thread that has not made it before (each request thread of a server)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_FNS: dict = {}


def _kernel_fns() -> dict:
    """The C entry points of ``csrc/cosine.cu``, built and resolved once."""
    if not _FNS:
        from semanticlens_tpu_torch.utils import cuda_build

        lib = cuda_build.load("cosine")
        p, i = ctypes.c_void_p, ctypes.c_int
        tiled = lib.cosine_tiled_f32
        tiled.argtypes = [p, p, p, i, i, i, i, i, p]
        tiled.restype = i
        streaming = lib.cosine_streaming_f32
        streaming.argtypes = [p, p, p, i, i, i, i, p]
        streaming.restype = i
        _FNS.update(tiled=tiled, streaming=streaming)
    return _FNS


_ERRORS = {-1: "cuTensorMapEncodeTiled not found in the CUDA driver",
           -2: "the CUDA driver refused a TMA tensor map",
           -3: "no such kernel configuration, or M too large for the streaming kernel"}


def _check(err: int, variant: str):
    if err != 0:
        what = _ERRORS.get(err, f"cudaError {err}")
        raise RuntimeError(f"cosine {variant} kernel launch failed: {what}")


def _launch_streaming(x, y, out, plan: LaunchPlan, stream: int):
    batch, m, d = x.shape
    err = _kernel_fns()["streaming"](x.data_ptr(), y.data_ptr(), out.data_ptr(), batch, m, y.shape[1], d, stream)
    _check(err, "streaming")
    count("k1.launches.streaming")


def _launch_tiled(x, y, out, plan: LaunchPlan, stream: int):
    batch, m, d = x.shape
    err = _kernel_fns()["tiled"](x.data_ptr(), y.data_ptr(), out.data_ptr(), batch, m, y.shape[1], d,
                                 plan.config, stream)
    _check(err, "tiled")
    count("k1.launches.tiled")


_LAUNCH = {"streaming": _launch_streaming, "tiled": _launch_tiled}


def _kernel_operand(a: torch.Tensor, rows: int, d_pad: int) -> torch.Tensor:
    """(batch, rows, d_pad) float32, contiguous and 16-byte aligned; no copy when already so."""
    if a.dtype != torch.float32:
        a = a.to(torch.float32)
    a = pad_features(a, d_pad)
    if not a.is_contiguous() or a.data_ptr() % 16:
        a = a.clone(memory_format=torch.contiguous_format)
    return a.reshape(-1, rows, d_pad)


def cosine_similarity_matrix_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch K1 on CUDA tensors: (..., M, D) × (..., N, D) → (..., M, N) float32.

    Leading dimensions must match (they become the kernel's batch grid
    axis). :func:`plan_launch` picks the kernel from the shape.
    """
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"K1 needs both operands on one CUDA device, got {x.device} and {y.device}")
    if x.ndim < 2 or x.ndim != y.ndim or x.shape[:-2] != y.shape[:-2] or x.shape[-1] != y.shape[-1]:
        raise ValueError(f"K1 takes (..., M, D) and (..., N, D) with equal leading dims, "
                         f"got {tuple(x.shape)} and {tuple(y.shape)}")
    lead = x.shape[:-2]
    m, d = x.shape[-2:]
    n = y.shape[-2]
    batch = math.prod(lead)
    out = torch.empty((*lead, m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if d == 0:
        return out.zero_()  # no features: every row is a zero row
    plan = plan_launch(batch, m, n, d, _num_sms(x.device.index if x.device.index is not None
                                                else torch.cuda.current_device()))
    xk = _kernel_operand(x, m, plan.d_pad)
    yk = _kernel_operand(y, n, plan.d_pad)
    _LAUNCH[plan.variant](xk, yk, out, plan, torch.cuda.current_stream(x.device).cuda_stream)
    return out


def cosine_similarity_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Fused ``x̂ @ ŷᵀ`` for (..., M, D) × (..., N, D) → (..., M, N) float32.

    Zero rows give 0 similarity. CPU tensors take the plain version; CUDA
    tensors launch a kernel (no fallback).
    """
    if x.device.type == "cpu" and y.device.type == "cpu":
        return cosine_similarity_matrix_plain(x, y)
    return cosine_similarity_matrix_cuda(x, y)


_LAUNCH_COUNTERS = {"streaming": "k1.launches.streaming", "tiled": "k1.launches.tiled"}


def launch_counts() -> dict:
    """Kernel launches since the last reset, per variant and in total."""
    counted = counters()
    out = {variant: counted.get(name, 0) for variant, name in _LAUNCH_COUNTERS.items()}
    return {**out, "total": sum(out.values())}


def reset_launch_counts():
    reset(*_LAUNCH_COUNTERS.values())
