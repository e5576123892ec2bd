"""Plain references of the audit's selections: the collect top-k and the cosine search.

Collect: each component keeps the ``k`` largest aggregated activations
over the dataset, where ``k`` empty slots of value 0 come first and win
ties, so an image enters only with a value above 0 (the semantics of the
SemanticLens reference's ``ActMax``). ``ranked_values`` gives the values
such a selection holds, rank by rank.

Search: dense float32 cosine of each query against every component, then a
stable descending sort, in blocks of queries and components so that it
fits in memory.
"""

from __future__ import annotations

import torch


def aggregate(tap: torch.Tensor, how: str) -> torch.Tensor:
    """A component tap → (B, C): the spatial mean of an NCHW map, or the token mean of (B, T, C)."""
    if how == "aggregate_conv_mean":
        return tap.mean(dim=(2, 3))
    if how == "aggregate_transformer_mean":
        return tap.mean(dim=1)
    raise ValueError(f"no plain reference of the aggregation {how!r}")


def ranked(acts: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, N) activations → (C, k) values and image ids that a top-k with k zero-valued empty slots holds,
    descending; an empty slot has id −1."""
    padded = torch.cat([torch.zeros(acts.shape[0], k, dtype=acts.dtype, device=acts.device), acts], dim=1)
    values, order = torch.sort(padded, dim=1, descending=True, stable=True)
    ids = order[:, :k] - k
    return values[:, :k], ids.clamp_(min=-1)


def ranked_values(acts: torch.Tensor, k: int) -> torch.Tensor:
    """(C, N) activations → (C, k) the values a top-k with k zero-valued empty slots holds, descending."""
    return ranked(acts, k)[0]


def cosine(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(Q, D) × (N, D) → (Q, N) cosine similarity in float32: dots over the product of the norms."""
    dots = queries @ rows.t()
    return dots / (torch.linalg.vector_norm(queries, dim=1)[:, None] * torch.linalg.vector_norm(rows, dim=1)[None, :])


def search(queries: torch.Tensor, bank: torch.Tensor, k: int, *, query_block: int = 64,
           picked: torch.Tensor | None = None):
    """Top-k cosine search by a dense matrix and a stable sort.

    Returns ``(values (Q, k), indices (Q, k))`` and, with ``picked`` (Q, k)
    component indices chosen by someone else, the reference's cosine of
    each picked component (−inf where an index is out of range).
    """
    vals, idx, at_picked = [], [], []
    n = bank.shape[0]
    for s in range(0, queries.shape[0], query_block):
        sim = cosine(queries[s : s + query_block], bank)
        v, i = torch.sort(sim, dim=1, descending=True, stable=True)
        vals.append(v[:, :k])
        idx.append(i[:, :k])
        if picked is not None:
            p = picked[s : s + query_block].long()
            ok = (p >= 0) & (p < n)
            got = torch.gather(sim, 1, p.clamp(0, n - 1))
            at_picked.append(torch.where(ok, got, torch.full_like(got, -torch.inf)))
        del sim, v, i
    out = (torch.cat(vals), torch.cat(idx))
    return out + (torch.cat(at_picked),) if picked is not None else out
