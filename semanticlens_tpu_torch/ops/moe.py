"""Mixture-of-experts feed-forward: routing, dispatch by expert, grouped expert GEMMs, the weighted combine.

DeepSeek-V2's routed experts (arXiv:2405.04434; HF ``modeling_deepseek.py``
``MoEGate`` and ``DeepseekV2MoE.moe_infer``), in four steps over a (N, H)
token matrix:

- :func:`route`: router logits ``x · W_gᵀ`` in float32, a softmax over the
  experts, the greedy top-k; the weights are the raw scores (times a
  scaling factor, 1 in DeepSeek-V2-Lite), or renormalised over the k;
- :func:`dispatch`: the (token, expert) pairs sorted by expert (a stable
  argsort of the flat expert ids), each expert's token count and the
  groups' end offsets, all on the tokens' device: nothing is read back;
- :func:`expert_ffn`: each expert's SwiGLU over its contiguous group of
  pairs, ``down_e(silu(gate_e x) ⊙ up_e x)``, as grouped GEMMs with the
  gate and up projections stacked into one (E, 2·I, H) weight;
- :func:`combine`: each token's k outputs times their weights, summed in
  float32 in slot order and rounded once to the outputs' dtype, as HF's
  ``moe_infer`` sums its weighted outputs in the weights' float32. On the
  card a hand-written gather-sum kernel (``csrc/moe.cu``; its design and
  bound are noted there) reads each pair's row once through the inverse
  permutation :func:`dispatch` makes, with no atomics and no float32
  intermediate; on the CPU its plain version, :func:`combine_plain`. A
  CUDA tensor launches the kernel or raises, and each launch counts under
  the tracer's counter ``moe.combine.kernel``.

:func:`scatter_tap` lays the experts' activations ``silu(gate_e x)`` out as
a (N, E·I) expert-major tap, zero where an expert was not routed the token
(it computed nothing for it); it runs only when the tap is asked for.

On the card the grouped GEMMs are ``torch._grouped_mm`` (bf16, one launch
per projection for all experts, the groups' offsets read on the device);
on the CPU, the plain version, a loop over the experts' groups.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from semanticlens_tpu_torch.utils.profiling import count

# csrc/moe.cu's element types, the code its entry point takes for each: bf16, the model's; float32, lm_audit's subject
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_KERNEL_ERRORS = {-1: "k < 1 or a width that is not a multiple of 8", -2: "no such element type",
                  -3: "an operand that is not 16-byte aligned"}


class Dispatch(NamedTuple):
    """The (token, expert) pairs of one layer, sorted by expert.

    ``token`` (P,): each sorted pair's token; ``expert`` (P,): its expert;
    ``counts`` (E,): pairs per expert (int64); ``offsets`` (E,): the groups'
    cumulative ends (int32, the grouped GEMM's ``offs``); ``pos`` (P,): where
    pair token · k + slot sits in the sorted order (int32).
    """

    token: torch.Tensor
    expert: torch.Tensor
    counts: torch.Tensor
    offsets: torch.Tensor
    pos: torch.Tensor


def route(x: torch.Tensor, gate_weight: torch.Tensor, top_k: int, *, norm_topk_prob: bool = False,
          scaling_factor: float = 1.0):
    """(N, H) tokens → (scores (N, E), weights (N, k), experts (N, k)); scores and weights float32.

    Greedy top-k of the softmax scores; ties keep the lower expert id.
    """
    logits = F.linear(x.float(), gate_weight.float())
    scores = logits.softmax(dim=-1)
    weights, experts = torch.topk(scores, top_k, dim=-1)
    if top_k > 1 and norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        weights = weights * scaling_factor
    return scores, weights, experts


def dispatch(experts: torch.Tensor, n_experts: int) -> Dispatch:
    """Sort the (token, expert) pairs of ``experts`` (N, k) by expert, on their device, without a host read."""
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    expert = flat[order]
    # scatter_add_ sizes its output from the argument (bincount reads the largest id back to the host)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    offsets = torch.cumsum(counts, dim=0).to(torch.int32)
    pos = torch.empty(flat.numel(), dtype=torch.int32, device=flat.device).scatter_(
        0, order, torch.arange(flat.numel(), dtype=torch.int32, device=flat.device))
    return Dispatch(order // experts.shape[1], expert, counts, offsets, pos)


def grouped_linear(x: torch.Tensor, weight: torch.Tensor, d: Dispatch, *, grouped: bool | None = None):
    """Each pair's row of ``x`` (P, in), sorted by expert, times its expert's ``weight`` (E, out, in) → (P, out).

    ``grouped`` (default: on the card) runs ``torch._grouped_mm`` over the
    groups the offsets bound; otherwise the plain loop over the experts,
    which reads the counts on the host.
    """
    weight = weight.to(x.dtype)
    if grouped if grouped is not None else x.is_cuda:
        return torch._grouped_mm(x, weight.transpose(-2, -1), offs=d.offsets)
    out = x.new_empty(x.shape[0], weight.shape[1])
    start = 0
    for e, n in enumerate(d.counts.tolist()):
        out[start : start + n] = x[start : start + n] @ weight[e].t()
        start += n
    return out


def expert_ffn(x_sorted: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor, d: Dispatch, *,
               grouped: bool | None = None):
    """The routed experts' SwiGLU over their sorted pairs → (act (P, I), out (P, H)).

    ``gate_up`` (E, 2·I, H) stacks each expert's gate and up projections;
    ``down`` (E, H, I). ``act`` is ``silu(gate_e x)``, the experts' tap.
    """
    inter = gate_up.shape[1] // 2
    gu = grouped_linear(x_sorted, gate_up, d, grouped=grouped)
    act = F.silu(gu[:, :inter])
    return act, grouped_linear(act * gu[:, inter:], down, d, grouped=grouped)


def combine_plain(y_sorted: torch.Tensor, weights: torch.Tensor, d: Dispatch, n_tokens: int) -> torch.Tensor:
    """The plain version of :func:`combine`: each token's k rows of ``y_sorted`` gathered in slot order, times
    their weights and summed in float32, cast to the outputs' dtype."""
    k = weights.shape[1]
    rows = y_sorted.index_select(0, d.pos).view(n_tokens, k, y_sorted.shape[1])
    return (rows.float() * weights[..., None]).sum(1).to(y_sorted.dtype)


_FNS: dict = {}


def _kernel():
    """The C entry point of ``csrc/moe.cu``, built and resolved once."""
    if not _FNS:
        from semanticlens_tpu_torch.utils import cuda_build

        fn = cuda_build.load("moe").moe_combine
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = i
        _FNS["combine"] = fn
    return _FNS["combine"]


def combine_cuda(y_sorted: torch.Tensor, weights: torch.Tensor, d: Dispatch, n_tokens: int) -> torch.Tensor:
    """Launch ``csrc/moe.cu``'s gather-sum on CUDA tensors → (N, H) in the outputs' dtype."""
    if y_sorted.device.type != "cuda" or weights.device != y_sorted.device or d.pos.device != y_sorted.device:
        raise ValueError(f"the combine kernel needs its operands on one CUDA device, got {y_sorted.device}, "
                         f"{weights.device} and {d.pos.device}")
    (p, h), k = y_sorted.shape, weights.shape[1]
    if weights.shape != (n_tokens, k) or p != n_tokens * k or d.pos.shape != (p,):
        raise ValueError(f"the combine takes (N·k, H) outputs, (N, k) weights and N·k positions, got "
                         f"{tuple(y_sorted.shape)}, {tuple(weights.shape)} and {tuple(d.pos.shape)} for N={n_tokens}")
    if y_sorted.dtype not in _KERNEL_DTYPES or weights.dtype != torch.float32 or d.pos.dtype != torch.int32:
        raise ValueError(f"the combine kernel takes {sorted(map(str, _KERNEL_DTYPES))} outputs, float32 weights and "
                         f"int32 positions, got {y_sorted.dtype}, {weights.dtype} and {d.pos.dtype}")
    if h % 8:
        raise ValueError(f"the combine kernel takes widths that are multiples of 8 (16-byte rows), got {h}")
    y = y_sorted.contiguous()
    out = torch.empty(n_tokens, h, dtype=y.dtype, device=y.device)
    err = _kernel()(y.data_ptr(), d.pos.contiguous().data_ptr(), weights.contiguous().data_ptr(), out.data_ptr(),
                    n_tokens, k, h, _KERNEL_DTYPES[y.dtype], torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"combine kernel launch failed: {_KERNEL_ERRORS.get(err, f'cudaError {err}')}")
    count("moe.combine.kernel")
    return out


def combine(y_sorted: torch.Tensor, weights: torch.Tensor, d: Dispatch, n_tokens: int) -> torch.Tensor:
    """Σ over each token's k pairs of weight × output, in float32 in slot order, rounded once to the outputs'
    dtype → (N, H).

    ``y_sorted`` (P, H): the pairs' outputs in ``d``'s sorted order;
    ``weights`` (N, k) float32. A CPU tensor takes :func:`combine_plain`;
    a CUDA tensor launches the kernel or raises.
    """
    if y_sorted.device.type == "cpu":
        return combine_plain(y_sorted, weights, d, n_tokens)
    return combine_cuda(y_sorted, weights, d, n_tokens)


def scatter_tap(act_sorted: torch.Tensor, d: Dispatch, n_tokens: int, n_experts: int) -> torch.Tensor:
    """The experts' activations as a (N, E·I) expert-major tap: pair (t, e)'s row at ``[t, e·I : (e+1)·I]``,
    zero where expert e was not routed token t."""
    inter = act_sorted.shape[1]
    tap = act_sorted.new_zeros(n_tokens * n_experts, inter)
    tap.index_copy_(0, d.token * n_experts + d.expert, act_sorted)
    return tap.view(n_tokens, n_experts * inter)
