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
- :func:`combine`: each pair's output times its weight, summed per token
  in float32 (``index_add_``), as HF sums its weighted outputs in the
  weights' float32.

:func:`scatter_tap` lays the experts' activations ``silu(gate_e x)`` out as
a (N, E·I) expert-major tap, zero where an expert was not routed the token
(it computed nothing for it); it runs only when the tap is asked for.

On the card the grouped GEMMs are ``torch._grouped_mm`` (bf16, one launch
per projection for all experts, the groups' offsets read on the device);
on the CPU, the plain version, a loop over the experts' groups.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class Dispatch(NamedTuple):
    """The (token, expert) pairs of one layer, sorted by expert.

    ``order`` (P,): flat pair index (token · k + slot) of each sorted pair;
    ``token`` (P,): its token; ``expert`` (P,): its expert; ``counts`` (E,):
    pairs per expert (int64); ``offsets`` (E,): the groups' cumulative ends
    (int32, the grouped GEMM's ``offs``).
    """

    order: torch.Tensor
    token: torch.Tensor
    expert: torch.Tensor
    counts: torch.Tensor
    offsets: torch.Tensor


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
    return Dispatch(order, order // experts.shape[1], expert, counts, offsets)


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


def combine(y_sorted: torch.Tensor, weights: torch.Tensor, d: Dispatch, n_tokens: int) -> torch.Tensor:
    """Σ over each token's pairs of weight × output, in float32 → (N, H)."""
    w = weights.reshape(-1)[d.order]
    out = torch.zeros(n_tokens, y_sorted.shape[1], dtype=torch.float32, device=y_sorted.device)
    return out.index_add_(0, d.token, y_sorted.float() * w[:, None])


def scatter_tap(act_sorted: torch.Tensor, d: Dispatch, n_tokens: int, n_experts: int) -> torch.Tensor:
    """The experts' activations as a (N, E·I) expert-major tap: pair (t, e)'s row at ``[t, e·I : (e+1)·I]``,
    zero where expert e was not routed token t."""
    inter = act_sorted.shape[1]
    tap = act_sorted.new_zeros(n_tokens * n_experts, inter)
    tap.index_copy_(0, d.token * n_experts + d.expert, act_sorted)
    return tap.view(n_tokens, n_experts * inter)
