"""Kimi Delta Attention's two hand-written steps: the short convolutions that make q, k and v, and the recurrence.

KDA (Kimi Linear, arXiv:2510.26692, in the form of fla-org's
``fla/layers/kda.py``, the layer HF's ``modeling_kimi.py`` uses) makes q, k
and v from three projections of its input by a causal depthwise
convolution of width 4 over the tokens (zero-padded at each sequence's
start, without bias) and a SiLU each, then L2-norms q and k per head (ε
1e-6, fla's ``l2norm``) and scales q by d^-½. :func:`short_conv` takes the
three projections (B, T, h·d) as ``linear`` returns them and the three
weights (h·d, 1, 4), and returns q, k, v (B, T, h, d) in the projections'
dtype; with ``norm=False`` all three stop after the SiLU (where a caller taps
the convolutions' output and norms q and k itself, :func:`norm_qk`).

The recurrence then carries a d × d state S per (sequence, head) from token
to token, 0 at the sequence's start. At token t, with α_t = exp(g_t) the
decay of each key channel (g in log space), q_t and k_t as above, v_t and
the write strength β_t:

    S ← Diag(α_t) S;   S ← S + β_t k_t (v_t − Sᵀ k_t)ᵀ;   o_t = Sᵀ q_t

:func:`recurrence` takes (B, T, h, d) ``q``, ``k``, ``v`` in the model's
dtype, float32 ``g`` (B, T, h, d) and ``beta`` (B, T, h), and returns
``o`` (B, T, h, d) in ``v``'s dtype.

On the card each is one hand-written kernel of ``csrc/kda.cu`` (their
designs and bounds are noted there) over the whole batch, one launch a
layer: the convolutions read the projections' rows as they lie and write q,
k, v in the recurrence's layout, in float32 with one rounding at the end,
each launch counted under the tracer's counter ``kda.conv.kernel``; the
recurrence keeps the state in registers, never in device memory, each
launch counted under ``kda.kernel``. On the CPU their plain versions,
:func:`short_conv_plain` (``F.conv1d``, SiLU, the float32 norms) and
:func:`recurrence_plain` (a loop over the tokens in float32). A CUDA tensor
launches the kernel or raises.

The recurrence's chunked tensor-core form of the paper (the WY / UT
representation within a chunk, the state carried between chunks) computes
the same function; it is not built.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from semanticlens_tpu_torch.utils.profiling import count

L2_EPS = 1e-6  # fla's l2norm, applied to q and k inside its KDA kernels
# csrc/kda.cu's element types, the code its entry points take for each
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_KERNEL_ERRORS = {-1: "a head size other than 128, a convolution width other than 4, or a bad size",
                  -2: "no such element type"}
_KERNEL_HEAD_DIM = 128
_KERNEL_CONV_WIDTH = 4
_FNS: dict = {}


def l2_normalize(x: torch.Tensor, eps: float = L2_EPS) -> torch.Tensor:
    """``x · rsqrt(Σ x² + eps)`` over the last axis, in float32."""
    xf = x.float()
    return xf * torch.rsqrt(xf.square().sum(dim=-1, keepdim=True) + eps)


def norm_qk(q: torch.Tensor, k: torch.Tensor):
    """(B, T, h, d) q and k unit-normed per head in float32, q also scaled by d^-½, back to their dtype."""
    return (l2_normalize(q) * q.shape[-1] ** -0.5).to(q.dtype), l2_normalize(k).to(k.dtype)


def _check_conv(xs, ws, head_dim: int) -> None:
    shape = xs[0].shape
    if len(shape) != 3 or any(x.shape != shape for x in xs) or shape[-1] % head_dim:
        raise ValueError(f"the short convolutions take (B, T, h·d) projections with d = {head_dim}, got "
                         f"{[tuple(x.shape) for x in xs]}")
    c = shape[-1]
    if any(w.ndim != 3 or w.shape[:2] != (c, 1) or w.shape != ws[0].shape for w in ws):
        raise ValueError(f"the short convolutions take ({c}, 1, width) depthwise weights, got "
                         f"{[tuple(w.shape) for w in ws]}")


def short_conv_plain(xq: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                     wv: torch.Tensor, *, head_dim: int, norm: bool = True):
    """The plain version of :func:`short_conv`: ``F.conv1d`` in the (B, C, T) layout and SiLU in the projections'
    dtype, then (``norm``) the float32 L2 norms of q and k → q, k, v (B, T, h, d) in the projections' dtype."""
    _check_conv((xq, xk, xv), (wq, wk, wv), head_dim)
    b, t, c = xq.shape
    out = []
    for x, w in ((xq, wq), (xk, wk), (xv, wv)):
        w = w.to(x.dtype)
        conv = F.conv1d(x.transpose(1, 2), w, padding=w.shape[-1] - 1, groups=w.shape[0])[..., :t]
        out.append(F.silu(conv.transpose(1, 2).contiguous()).view(b, t, c // head_dim, head_dim))
    q, k, v = out
    return (*norm_qk(q, k), v) if norm else (q, k, v)


def _check(q, k, v, g, beta) -> None:
    if not (q.shape == k.shape == v.shape == g.shape) or q.ndim != 4 or beta.shape != q.shape[:3]:
        raise ValueError(f"the recurrence takes (B, T, h, d) q, k, v, g and (B, T, h) beta, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(g.shape)} and {tuple(beta.shape)}")


def recurrence_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                     beta: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`recurrence`: a loop over the tokens in float32, o in ``v``'s dtype."""
    _check(q, k, v, g, beta)
    b, t, h, d = q.shape
    qf, kf, vf, alpha, bf = q.float(), k.float(), v.float(), g.float().exp(), beta.float()
    s = torch.zeros(b, h, d, d, dtype=torch.float32, device=q.device)
    o = torch.empty(b, t, h, d, dtype=torch.float32, device=q.device)
    for i in range(t):
        s = s * alpha[:, i, :, :, None]
        u = torch.einsum("bhkv,bhk->bhv", s, kf[:, i])
        s = s + bf[:, i, :, None, None] * kf[:, i, :, :, None] * (vf[:, i] - u)[:, :, None, :]
        o[:, i] = torch.einsum("bhkv,bhk->bhv", s, qf[:, i])
    return o.to(v.dtype)


def _kernel(name: str):
    """The C entry point ``kda_<name>`` of ``csrc/kda.cu``, built and resolved once."""
    if not _FNS:
        from semanticlens_tpu_torch.utils import cuda_build

        lib = cuda_build.load("kda")
        p, i = ctypes.c_void_p, ctypes.c_int
        _FNS["recurrence"] = lib.kda_recurrence
        _FNS["recurrence"].argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        _FNS["short_conv"] = lib.kda_short_conv
        _FNS["short_conv"].argtypes = [p] * 9 + [i] * 6 + [ctypes.c_float, i, p]
        for fn in _FNS.values():
            fn.restype = i
    return _FNS[name]


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte aligned address (the kernels' vector loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def short_conv_cuda(xq: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                    wv: torch.Tensor, *, head_dim: int, norm: bool = True):
    """Launch ``csrc/kda.cu``'s short convolutions on CUDA tensors → q, k, v (B, T, h, d) in the projections'
    dtype."""
    _check_conv((xq, xk, xv), (wq, wk, wv), head_dim)
    xs, ws = (xq, xk, xv), (wq, wk, wv)
    devices = {x.device for x in xs + ws}
    if len(devices) != 1 or xq.device.type != "cuda":
        raise ValueError(f"the short convolution kernel needs its operands on one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    if len({x.dtype for x in xs}) != 1 or xq.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the short convolution kernel takes projections of one type of "
                         f"{sorted(map(str, _KERNEL_DTYPES))}, got {[x.dtype for x in xs]}")
    b, t, c = xq.shape
    if head_dim != _KERNEL_HEAD_DIM or wq.shape[-1] != _KERNEL_CONV_WIDTH:
        raise ValueError(f"the short convolution kernel takes the head size {_KERNEL_HEAD_DIM} and the width "
                         f"{_KERNEL_CONV_WIDTH}, got {head_dim} and {wq.shape[-1]}")
    xs = tuple(_aligned(x) for x in xs)
    ws = tuple(_aligned(w.to(xq.dtype)) for w in ws)
    out = tuple(torch.empty(b, t, c // head_dim, head_dim, dtype=xq.dtype, device=xq.device) for _ in range(3))
    err = _kernel("short_conv")(*(x.data_ptr() for x in xs + ws + out), b, t, c, head_dim, _KERNEL_CONV_WIDTH,
                                int(norm), head_dim**-0.5, _KERNEL_DTYPES[xq.dtype],
                                torch.cuda.current_stream(xq.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"short convolution kernel launch failed: {_KERNEL_ERRORS.get(err, f'cudaError {err}')}")
    count("kda.conv.kernel")
    return out


def short_conv(xq: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
               wv: torch.Tensor, *, head_dim: int, norm: bool = True):
    """KDA's three short convolutions → q, k, v (B, T, h, d) in the projections' dtype: ``SiLU(conv(x))`` each and,
    with ``norm``, q and k unit-normed per head and q scaled by d^-½.

    A CPU tensor takes :func:`short_conv_plain`; a CUDA tensor launches the
    kernel or raises.
    """
    if xq.device.type == "cpu":
        return short_conv_plain(xq, xk, xv, wq, wk, wv, head_dim=head_dim, norm=norm)
    return short_conv_cuda(xq, xk, xv, wq, wk, wv, head_dim=head_dim, norm=norm)


def recurrence_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                    beta: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/kda.cu``'s recurrence on CUDA tensors → o (B, T, h, d) in ``v``'s dtype."""
    _check(q, k, v, g, beta)
    devices = {x.device for x in (q, k, v, g, beta)}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"the recurrence kernel needs its operands on one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the recurrence kernel takes q, k and v of one type of {sorted(map(str, _KERNEL_DTYPES))}, "
                         f"got {q.dtype}, {k.dtype} and {v.dtype}")
    if g.dtype != torch.float32 or beta.dtype != torch.float32:
        raise ValueError(f"the recurrence kernel takes float32 g and beta, got {g.dtype} and {beta.dtype}")
    b, t, h, d = q.shape
    if d != _KERNEL_HEAD_DIM:
        raise ValueError(f"the recurrence kernel takes the head size {_KERNEL_HEAD_DIM}, got {d}")
    q, k, v, g, beta = (x.contiguous() for x in (q, k, v, g, beta))
    o = torch.empty_like(v)
    err = _kernel("recurrence")(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), beta.data_ptr(),
                                o.data_ptr(), b, t, h, d, _KERNEL_DTYPES[q.dtype],
                                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"recurrence kernel launch failed: {_KERNEL_ERRORS.get(err, f'cudaError {err}')}")
    count("kda.kernel")
    return o


def recurrence(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """KDA's gated delta rule over every (sequence, head) of the batch → o (B, T, h, d) in ``v``'s dtype.

    A CPU tensor takes :func:`recurrence_plain`; a CUDA tensor launches the
    kernel or raises.
    """
    if q.device.type == "cpu":
        return recurrence_plain(q, k, v, g, beta)
    return recurrence_cuda(q, k, v, g, beta)
