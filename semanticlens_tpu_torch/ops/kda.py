"""Kimi Delta Attention's recurrence: the gated delta rule over each sequence, a float32 state per (sequence, head).

KDA (Kimi Linear, arXiv:2510.26692, in the form of fla-org's
``fla/layers/kda.py``, the layer HF's ``modeling_kimi.py`` uses) carries a
d × d state S per (sequence, head) from token to token, 0 at the
sequence's start. At token t, with α_t = exp(g_t) the decay of each key
channel (g in log space), q_t and k_t unit-normed per head (q also scaled
by d^-½; the caller does both), v_t and the write strength β_t:

    S ← Diag(α_t) S;   S ← S + β_t k_t (v_t − Sᵀ k_t)ᵀ;   o_t = Sᵀ q_t

:func:`recurrence` takes (B, T, h, d) ``q``, ``k``, ``v`` in the model's
dtype, float32 ``g`` (B, T, h, d) and ``beta`` (B, T, h), and returns
``o`` (B, T, h, d) in ``v``'s dtype. On the card a hand-written kernel
(``csrc/kda.cu``; its design and bound are noted there) runs the whole
batch in one launch, the state in registers, never in device memory; each
launch counts under the tracer's counter ``kda.kernel``. On the CPU its
plain version, :func:`recurrence_plain`, a loop over the tokens in
float32. A CUDA tensor launches the kernel or raises.

The chunked tensor-core form of the paper (the WY / UT representation
within a chunk, the state carried between chunks) computes the same
function; it is not built.
"""

from __future__ import annotations

import ctypes

import torch

from semanticlens_tpu_torch.utils.profiling import count

# csrc/kda.cu's element types, the code its entry point takes for each
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_KERNEL_ERRORS = {-1: "a head size other than 128, or a negative size", -2: "no such element type"}
_KERNEL_HEAD_DIM = 128
_FNS: dict = {}


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


def _kernel():
    """The C entry point of ``csrc/kda.cu``, built and resolved once."""
    if not _FNS:
        from semanticlens_tpu_torch.utils import cuda_build

        fn = cuda_build.load("kda").kda_recurrence
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
        _FNS["recurrence"] = fn
    return _FNS["recurrence"]


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
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), beta.data_ptr(), o.data_ptr(), b, t, h,
                    d, _KERNEL_DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
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
