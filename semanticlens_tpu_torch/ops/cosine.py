"""Fused cosine-similarity matrix: the hand-written CUDA kernel K1, its top-k form K1b, and their plain versions.

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

**K1b** (:func:`cosine_topk_candidates`, for ``scores.topk_cosine_search``)
is the tiled kernel with a selecting epilogue: one persistent launch keeps
each row's k ≤ ``K1B_MAX_K`` best (value, column) of each of ``splits``
column ranges in shared memory and writes only those, (M, splits·k);
:func:`merge_candidates` (one stable descending sort) finishes the top-k.
Its scores are bitwise the tiled kernel's. It counts under
``k1.launches.tiled``. :func:`takes_k1b` says which searches take it, from
the device, the shape and k; :func:`cosine_topk_plain` is its plain version.
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
# K1b runs at config 0's tile; each row's ranked list of K1B_MAX_K entries fills
# the shared memory its four stages leave. D above FLUSH_K gives it a buffer of
# flushed partial sums, one tile per block.
K1B_TILE = TILE_CONFIGS[0]
K1B_MAX_K = 32
FLUSH_K = 512
# What a split costs K1b besides its tiles, in tiles: its first tiles, while the
# lists fill, insert far more than the rest (≈ 1 ms a block against ≈ 42 µs a
# tile at 1024 × 1,048,576 × 512 on an H100; the split sweep in PERF.md).
K1B_SPLIT_TILES = 24


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


def _streams(m: int, n: int, d_pad: int) -> bool:
    """Whether K1 takes its streaming kernel for (M, d_pad) × (N, d_pad)."""
    return m <= STREAMING_MAX_M and m * n <= STREAMING_MAX_MN and m * d_pad * 4 <= STREAMING_MAX_X_BYTES


def plan_launch(batch: int, m: int, n: int, d: int, num_sms: int) -> LaunchPlan:
    """The launch of K1 for (batch, M, D) × (batch, N, D) on a card with ``num_sms`` SMs."""
    for name, v in (("batch", batch), ("M", m), ("N", n), ("D", d)):
        if v > _INT32_MAX:
            raise ValueError(f"{name}={v} exceeds the kernel's int32 range")
    if batch > 65535:
        raise ValueError(f"batch={batch} exceeds the kernel's grid limit of 65535")
    d_pad = -(-d // 4) * 4
    if _streams(m, n, d_pad):
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
        topk = lib.cosine_topk_tiled_f32
        topk.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        topk.restype = i
        _FNS.update(tiled=tiled, streaming=streaming, topk=topk)
    return _FNS


_ERRORS = {-1: "cuTensorMapEncodeTiled not found in the CUDA driver",
           -2: "the CUDA driver refused a TMA tensor map",
           -3: "no such kernel configuration, M too large for the streaming kernel, or k or splits out of "
               "K1b's range"}


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


# --------------------------------------------------------------------------- #
# K1b: per-row top-k in the tiled kernel's epilogue
# --------------------------------------------------------------------------- #
def takes_k1b(device: torch.device, q: int, n: int, d: int, k: int) -> bool:
    """Whether a top-k search of (Q, D) queries over (N, D) components runs K1b.

    On a CUDA device, where K1 would take its tiled kernel for (Q, N), for
    ``1 ≤ k ≤ K1B_MAX_K`` and D ≥ 1; every other search streams the bank
    through K1 in chunks (``scores.topk_cosine_search``).
    """
    return device.type == "cuda" and 1 <= k <= K1B_MAX_K and d >= 1 and not _streams(q, n, -(-d // 4) * 4)


@functools.lru_cache(maxsize=256)
def k1b_splits(m: int, n: int, num_sms: int) -> int:
    """The column splits of K1b's grid for (M, N): the least work on the busiest SM (one block an SM, blocks
    in waves, each its tiles and ``K1B_SPLIT_TILES``), then the fewest splits (the shorter merge)."""
    bm, bn = K1B_TILE
    blocks, tiles = math.ceil(m / bm), math.ceil(n / bn)

    def busiest(s):
        return math.ceil(blocks * s / num_sms) * (math.ceil(tiles / s) + K1B_SPLIT_TILES)

    return min(range(1, min(tiles, 2 * num_sms) + 1), key=lambda s: (busiest(s), s))


def split_bounds(n: int, splits: int, tile: int = K1B_TILE[1]) -> list[int]:
    """Column boundaries of K1b's splits: split s covers whole tiles [s·T // splits, (s+1)·T // splits) of T."""
    tiles = math.ceil(n / tile)
    return [min(s * tiles // splits * tile, n) for s in range(splits + 1)]


def topk_candidates_plain(sim: torch.Tensor, k: int, splits: int, tile: int = K1B_TILE[1]):
    """K1b's output from a (Q, N) score matrix: each split's first k (value, column), ranked, side by side in
    split order, (Q, splits·k) float32 and int32.

    Ranked as the kernel ranks: the larger value first, NaN above every number, the lower column on equal
    values (a stable descending sort). A split narrower than k pads with (−inf, INT32_MAX).
    """
    q = sim.shape[0]
    vals, cols = [], []
    bounds = split_bounds(sim.shape[1], splits, tile)
    for c0, c1 in zip(bounds, bounds[1:]):
        v, order = torch.sort(sim[:, c0:c1], dim=1, descending=True, stable=True)
        v, c = v[:, :k], (order[:, :k] + c0).to(torch.int32)
        pad = k - v.shape[1]
        vals += [v, torch.full((q, pad), -torch.inf, dtype=v.dtype, device=v.device)]
        cols += [c, torch.full((q, pad), _INT32_MAX, dtype=torch.int32, device=v.device)]
    return torch.cat(vals, dim=1), torch.cat(cols, dim=1)


def merge_candidates(cand_v: torch.Tensor, cand_c: torch.Tensor, k: int):
    """The top-k of K1b's candidates: one stable descending sort by value, cut to k.

    Exact because the splits' columns ascend in split order: among equal values the lower column comes first.
    """
    vals, order = torch.sort(cand_v, dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(cand_c, 1, order[:, :k])


def cosine_topk_plain(x: torch.Tensor, y: torch.Tensor, k: int, splits: int, tile: int = K1B_TILE[1]):
    """K1b's plain version: the top-k of (Q, D) × (N, D) by splits and merge, ``(values, int32 columns)``."""
    return merge_candidates(*topk_candidates_plain(cosine_similarity_matrix_plain(x, y), k, splits, tile), k)


def cosine_topk_candidates(x: torch.Tensor, y: torch.Tensor, k: int):
    """Launch K1b on CUDA tensors (Q, D) × (N, D): its (Q, splits·k) candidates, for :func:`merge_candidates`."""
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"K1b needs both operands on one CUDA device, got {x.device} and {y.device}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"K1b takes (Q, D) and (N, D), got {tuple(x.shape)} and {tuple(y.shape)}")
    (q, d), n = x.shape, y.shape[0]
    if not takes_k1b(x.device, q, n, d, k):
        raise ValueError(f"K1b does not take Q={q}, N={n}, D={d}, k={k}")
    num_sms = _num_sms(x.device.index if x.device.index is not None else torch.cuda.current_device())
    plan = plan_launch(1, q, n, d, num_sms)
    splits = k1b_splits(q, n, num_sms)
    xk = _kernel_operand(x, q, plan.d_pad)
    yk = _kernel_operand(y, n, plan.d_pad)
    cand_v = torch.empty((q, splits * k), dtype=torch.float32, device=x.device)
    cand_c = torch.empty((q, splits * k), dtype=torch.int32, device=x.device)
    bm, bn = K1B_TILE
    part = (torch.empty((math.ceil(q / bm) * splits, bm, bn), dtype=torch.float32, device=x.device)
            if plan.d_pad > FLUSH_K else None)
    err = _kernel_fns()["topk"](xk.data_ptr(), yk.data_ptr(), None if part is None else part.data_ptr(),
                                cand_v.data_ptr(), cand_c.data_ptr(), q, n, plan.d_pad, k, splits,
                                torch.cuda.current_stream(x.device).cuda_stream)
    _check(err, "top-k tiled")
    count("k1.launches.tiled")
    return cand_v, cand_c


_LAUNCH_COUNTERS = {"streaming": "k1.launches.streaming", "tiled": "k1.launches.tiled"}


def launch_counts() -> dict:
    """Kernel launches since the last reset, per variant and in total."""
    counted = counters()
    out = {variant: counted.get(name, 0) for variant, name in _LAUNCH_COUNTERS.items()}
    return {**out, "total": sum(out.values())}


def reset_launch_counts():
    reset(*_LAUNCH_COUNTERS.values())
