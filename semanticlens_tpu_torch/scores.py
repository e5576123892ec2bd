"""Concept-quality scores on torch tensors.

Counterpart of ``semanticlens_tpu.scores``, every function of it, with the
same numerical conventions (all in float32) and the same dead-row, sentinel
and tie-order rules. Inputs may be tensors (kept on their device) or numpy
arrays (put on ``device``: the CUDA card unless the caller passes ``"cpu"``).

Every cosine matrix goes through :func:`_cosine_matrix`, which is the fused
kernel K1 (:mod:`semanticlens_tpu_torch.ops.cosine`) on the card — the path
by which probing (``cosine_probe``), ``redundancy_score``,
``topk_cosine_search``'s chunked path, ``soft_wpmi`` and
``match_components`` reach it. ``topk_cosine_search`` takes K1b, K1 with the
top-k in its epilogue, where the card, the shape and k allow.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from semanticlens_tpu_torch.ops.cosine import (
    cosine_similarity_matrix,
    cosine_topk_candidates,
    merge_candidates,
    takes_k1b,
)
from semanticlens_tpu_torch.core.mesh import ShardedRows, all_gather
from semanticlens_tpu_torch.ops.kmeans import batched_kmeans
from semanticlens_tpu_torch.utils.device import as_tensor
from semanticlens_tpu_torch.utils.profiling import count, span

logger = logging.getLogger(__name__)

__all__ = [
    "clarity_score",
    "redundancy_score",
    "similarity_score",
    "cosine_probe",
    "polysemanticity_score",
    "null_calibrated_polysemanticity",
    "topk_cosine_search",
    "class_composition",
    "soft_wpmi",
    "fastcav",
    "drift_score",
    "match_components",
    "semantic_coverage",
]


def _f32(x, device=None) -> torch.Tensor:
    return as_tensor(x, device=device, dtype=torch.float32)


def _normalize(x, dim=-1, eps=1e-12):
    """L2-normalize along ``dim`` (torch.nn.functional.normalize semantics)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def _cosine_matrix(x, y):
    """cos(x_i, y_j) for (..., M, D) × (..., N, D) → (..., M, N): kernel K1 on the card."""
    return cosine_similarity_matrix(x, y)


def _gathered(V: ShardedRows, local_scores):
    """Per-component scores of every rank's rows, all-gathered in component order."""
    return all_gather(local_scores, V.group).flatten(0, 1)


def clarity_score(V, device=None):
    """Clarity of each concept: how uniform its example embeddings are.

    V : (..., n_samples, n_features) → (...,) in [−1/(n_samples−1), 1].
    A :class:`~semanticlens_tpu_torch.core.mesh.ShardedRows` (``core.shard_concept_db``)
    is scored on this rank's components and the scores all-gathered.
    """
    if isinstance(V, ShardedRows):
        return _gathered(V, clarity_score(V.local, device))
    V = _f32(V, device)
    n = V.shape[-2]
    mean_embed = torch.mean(_normalize(V), dim=-2)
    return (torch.sum(mean_embed**2, dim=-1) - 1.0 / n) / (n - 1) * n


def redundancy_score(cones, device=None):
    """Mean over components of the max off-diagonal cosine: (..., C, D) → (...,).

    A component-sharded bank (``ShardedRows``) is gathered whole first: every
    component's maximum runs over all the others."""
    if isinstance(cones, ShardedRows):
        cones = cones.full()
    cones = _f32(cones, device)
    sims = _cosine_matrix(cones, cones)
    sims = sims - 2.0 * torch.eye(sims.shape[-1], dtype=sims.dtype, device=sims.device)
    return torch.amax(sims, dim=-1).mean(dim=-1)


def similarity_score(x, y, device=None):
    """Cosine similarity with the reference's shape dispatch.

    - different shapes, ``x.shape[1] == y.shape[0]``: ``x̂ @ ŷ`` (the
      reference's quirk: ŷ is row-normalized);
    - different shapes, ``x.shape[1] == y.shape[1]``: ``x̂ @ ŷᵀ``;
    - equal shapes: elementwise cosine along the last axis.
    """
    x = _f32(x, device)
    y = _f32(y, x.device)
    if x.shape != y.shape:
        if x.shape[1] == y.shape[0]:
            if y.shape[0] == y.shape[1]:
                logger.warning(
                    "similarity_score: y is square (%s); interpreting as x @ y "
                    "(reference dispatch). If y is a (components, features) "
                    "concept DB, use cosine_probe / pass y transposed.",
                    tuple(y.shape),
                )
            return _normalize(x) @ _normalize(y)
        if x.shape[1] == y.shape[1]:
            return _cosine_matrix(x, y)
        raise ValueError("x and y must have the same shape")
    return torch.sum(_normalize(x) * _normalize(y), dim=-1)


def cosine_probe(queries, concept_db, device=None):
    """Cosine similarity of (Q, D) queries against a (C, D) concept DB → (Q, C)."""
    queries = _f32(queries, device)
    concept_db = _f32(concept_db, queries.device)
    if queries.shape[-1] != concept_db.shape[-1]:
        raise ValueError(
            f"feature dims differ: queries {tuple(queries.shape)} vs concept_db {tuple(concept_db.shape)}"
        )
    return _cosine_matrix(queries, concept_db)


def polysemanticity_score(V, replace_empty_clusters: bool = True, random_state: int = 123,
                          n_clusters: int = 2, device=None):
    """Polysemanticity of each concept: 1 − clarity of its k-means centers.

    V : (n_neurons, n_samples, n_features). Neurons whose smallest cluster
    has < 2 members get ``1 − mean_i clarity([mean(V), V[:, i]])`` over the
    first ≤10 samples (the reference's empty-cluster fallback). A
    ``ShardedRows`` is scored on this rank's components, with each
    component's k-means draws those of the whole layer (``batched_kmeans``'s
    ``rows``), and the scores are all-gathered.
    """
    rows = None
    if isinstance(V, ShardedRows):
        sharded, rows, V = V, (V.start, V.total), V.local
    V = _f32(V, device)
    centers, _, counts = batched_kmeans(V, n_clusters, n_init=10, seed=random_state, rows=rows)
    poly = 1.0 - clarity_score(centers)
    if replace_empty_clusters:
        degenerate = torch.amin(counts, dim=-1) < 2
        num_samples = min(10, V.shape[1])
        v_mean = torch.mean(V, dim=1)
        pairs = torch.stack([v_mean[:, None].expand(-1, num_samples, -1), V[:, :num_samples]], dim=2)
        fallback = 1.0 - clarity_score(pairs).mean(dim=1)
        poly = torch.where(degenerate, fallback, poly)
    return poly if rows is None else _gathered(sharded, poly)


def _chunk_topk(sim, k: int):
    """The k best of each row of ``sim`` (Q, c): the largest values, the lower column first on ties.

    ``torch.topk`` (a radix select) takes every value above its k-th, but
    picks any of the values equal to it; that choice is exact when it took
    all of them. Otherwise the block is sorted, stably.
    """
    vals, cols = torch.topk(sim, k, dim=1)
    cut = vals[:, -1:]
    with span("search.tie_test"):  # the host waits here for the chunk's select
        exact = torch.equal((sim == cut).sum(dim=1), (vals == cut).sum(dim=1))
    if not exact:
        count("search.tie_fallbacks")
        vals, cols = torch.sort(sim, dim=1, descending=True, stable=True)
        vals, cols = vals[:, :k], cols[:, :k]
    return vals, cols


def _merge_topk(best_vals, best_idx, sim, start: int):
    """Merge a (Q, c) block of similarities for columns [start, start + c) into the running top-k.

    The result equals a stable descending sort of the state followed by the
    block, cut to k: on equal values the lower column wins, as ``lax.top_k``
    does in the JAX package (dead all-zero rows all score exactly 0: ties
    are common).
    """
    k = best_vals.shape[1]
    vals, cols = _chunk_topk(sim, min(k, sim.shape[1]))
    all_vals = torch.cat([best_vals, vals], dim=1)
    all_idx = torch.cat([best_idx, (cols + start).to(torch.int32)], dim=1)
    by_idx = torch.sort(all_idx, dim=1, stable=True).indices
    all_vals, all_idx = torch.gather(all_vals, 1, by_idx), torch.gather(all_idx, 1, by_idx)
    vals, order = torch.sort(all_vals, dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(all_idx, 1, order[:, :k])


def _chunked_topk(queries, components, k: int, chunk_size: int):
    """``components`` streamed through K1 ``chunk_size`` rows at a time, each block merged into a running (Q, k)
    state."""
    q, n = queries.shape[0], components.shape[0]
    chunk_size = min(chunk_size, max(n, 1))
    best_vals = torch.full((q, k), -torch.inf, dtype=torch.float32, device=queries.device)
    best_idx = torch.full((q, k), -1, dtype=torch.int32, device=queries.device)
    for start in range(0, n, chunk_size):
        with span("search.k1", queries.device):
            sim = _cosine_matrix(queries, components[start : start + chunk_size])
        with span("search.merge", queries.device):
            best_vals, best_idx = _merge_topk(best_vals, best_idx, sim, start)
    return best_vals, best_idx


def topk_cosine_search(queries, components, k: int, *, chunk_size: int = 65536, device=None):
    """Per-query top-k most similar components without materializing (Q, N).

    On the card, where K1 would take its tiled kernel for (Q, N) and
    ``k ≤ K1B_MAX_K`` (``ops.cosine.takes_k1b``), one launch of K1b keeps
    each query's k best of each of S column splits in its epilogue (S from
    ``ops.cosine.k1b_splits``: the blocks fill the card in whole waves) and
    one stable sort merges the (Q, S·k) candidates: peak memory O(Q·S·k),
    no host sync. Otherwise (the CPU, a
    few queries against a small bank, larger k) ``components`` stream
    through K1 ``chunk_size`` rows at a time, each block merged into a
    running (Q, k) state, so peak memory is O(Q·(k + chunk_size)). Both are
    exact: equal to a stable descending sort of the dense cosine matrix, cut
    to k.

    Returns ``(values (Q, k) float32 desc, indices (Q, k) int32)`` with
    global component row numbers.
    """
    with span("search.call"):
        with span("search.prepare"):
            queries = _f32(queries, device)
            components = _f32(components, queries.device)
            q, n = queries.shape[0], components.shape[0]
            if k > n:
                raise ValueError(f"k={k} exceeds component count {n}")
            fused = takes_k1b(queries.device, q, n, queries.shape[1], k)
        if not fused:
            return _chunked_topk(queries, components, k, chunk_size)
        count("search.k1b")
        with span("search.k1", queries.device):
            cand_v, cand_c = cosine_topk_candidates(queries, components, k)
        with span("search.merge", queries.device):
            return merge_candidates(cand_v, cand_c, k)


def class_composition(sample_ids, labels, n_classes: int | None = None):
    """Per-component class histogram of the collected top-k evidence (numpy).

    ``sample_ids`` (C, k) with −1 sentinels ignored, ``labels`` (N,) dataset
    labels. Returns ``counts (C, n_classes) int32`` and ``purity (C,)
    float32``, the largest class share per component (0 without evidence).
    """
    ids = np.asarray(sample_ids)
    labels = np.asarray(labels)
    if n_classes is None:
        n_classes = int(labels.max()) + 1 if labels.size else 1
    c, _k = ids.shape
    counts = np.zeros((c, n_classes), np.int32)
    rows, cols = np.nonzero(ids >= 0)
    np.add.at(counts, (rows, labels[ids[rows, cols]]), 1)
    totals = counts.sum(axis=1)
    purity = np.where(totals > 0, counts.max(axis=1) / np.maximum(totals, 1), 0.0).astype(np.float32)
    return counts, purity


def _wpmi_chunk(P, Pbar, ids_chunk, *, lam, p_start, p_end):
    """(c, k) evidence rows of ``P`` → (c, V) soft-WPMI scores.

    ``P`` (U, V) is p(word | image) for the evidence images, ``Pbar`` (V,)
    the dataset-mean word probability. Rank weights decay ``p_start →
    p_end`` over each row's valid slots, so −1 sentinels carry zero weight
    and extra sentinel columns leave a row's score unchanged.
    """
    valid = (ids_chunk >= 0).to(torch.float32)
    v = torch.sum(valid, dim=1)
    r = torch.arange(ids_chunk.shape[1], dtype=torch.float32, device=P.device)
    a = (p_start + (p_end - p_start) * r[None, :] / torch.clamp_min(v - 1.0, 1.0)[:, None]) * valid
    gathered = P[torch.clamp_min(ids_chunk, 0)]  # (c, k, V)
    terms = torch.log(torch.clamp_min(1.0 - a[..., None] + a[..., None] * gathered, 1e-7))
    log_p_d_given_w = torch.sum(terms, dim=1)
    abar = torch.sum(a, dim=1) / torch.clamp_min(v, 1.0)
    pbar_row = 1.0 - abar[:, None] + abar[:, None] * Pbar[None, :]
    log_p_d = v[:, None] * torch.log(torch.clamp_min(pbar_row, 1e-7))
    return log_p_d_given_w - lam * log_p_d


def soft_wpmi(vocab_embeds, image_embeds, evidence_ids, *, temperature: float = 10.0, lam: float = 1.0,
              p_start: float = 0.998, p_end: float = 0.97, chunk: int = 256, device=None):
    """CLIP-Dissect soft-WPMI concept-word scores (C, V) from each component's evidence images.

    ``wpmi(w, c) = log p(D_c | w) − λ·log p(D_c)`` with ``p(t | x) =
    softmax_V(temperature · cos(x, t))`` and rank-weighted soft membership.
    ``vocab_embeds`` (V, D), ``image_embeds`` (N, D) the dataset's embedding
    table, ``evidence_ids`` (C, k) with −1 sentinels. The (N, V) softmax
    table is never built: the dataset mean streams over image chunks and
    only the unique evidence rows are computed. Returns (C, V) float32 numpy.
    """
    vocab = _f32(vocab_embeds, device)
    table = _f32(image_embeds, vocab.device)
    ids = np.asarray(evidence_ids)
    if ids.ndim != 2:
        raise ValueError(f"evidence_ids must be (C, k), got {ids.shape}")
    n = table.shape[0]
    if ids.max(initial=-1) >= n:
        raise ValueError(f"evidence id {int(ids.max())} out of range for a {n}-row embedding table")

    def p_rows(rows):
        return torch.softmax(temperature * _cosine_matrix(rows, vocab), dim=1)

    img_chunk = max(chunk, 4096)
    psum = torch.zeros(vocab.shape[0], dtype=torch.float32, device=vocab.device)
    for i in range(0, n, img_chunk):
        psum = psum + torch.sum(p_rows(table[i : i + img_chunk]), dim=0)
    pbar = psum / n

    unique = np.unique(ids[ids >= 0])
    if unique.size == 0:
        return np.zeros((ids.shape[0], int(vocab.shape[0])), np.float32)
    p_need = p_rows(table[torch.as_tensor(unique, device=table.device)])  # (U, V)
    remap = np.searchsorted(unique, np.maximum(ids, 0))
    mapped = torch.as_tensor(np.where(ids >= 0, remap, -1), device=vocab.device)
    out = [_wpmi_chunk(p_need, pbar, mapped[i : i + chunk], lam=lam, p_start=p_start, p_end=p_end)
           for i in range(0, ids.shape[0], chunk)]
    return torch.cat(out).cpu().numpy().astype(np.float32)


def _aggregate_concepts(V, device=None):
    """(C, k, D) concept DB → (C, D) mean over the samples; (C, D) passes through."""
    V = _f32(V, device)
    if V.ndim == 3:
        V = torch.mean(V, dim=1)
    if V.ndim != 2:
        raise ValueError(f"expected (C, k, D) or (C, D) concept DB, got shape {tuple(V.shape)}")
    return V


_DEAD_NORM = 1e-8  # aggregated FM embeddings are O(1); sentinel rows are 0


def _dead(x):
    return torch.linalg.vector_norm(x, dim=-1) < _DEAD_NORM


def drift_score(V_a, V_b, device=None):
    """Per-component ``1 − cos(mean A_i, mean B_i)`` between two DBs of the same layer shape.

    Components dead on either side (all-zero rows) give NaN. Returns (C,) float32.
    """
    a = _aggregate_concepts(V_a, device)
    b = _aggregate_concepts(V_b, a.device)
    if a.shape != b.shape:
        raise ValueError(f"component mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")
    cos = torch.sum(_normalize(a) * _normalize(b), dim=-1)
    return torch.where(_dead(a) | _dead(b), torch.nan, 1.0 - cos)


def match_components(V_a, V_b, device=None):
    """Best semantic match in B for every component of A (C_a need not equal C_b).

    Returns ``(indices (C_a,) int32, cosines (C_a,) float32)``. Dead rows of A
    give index −1 and cosine NaN; dead rows of B never match (−inf); ties go
    to the first maximum.
    """
    a = _aggregate_concepts(V_a, device)
    b = _aggregate_concepts(V_b, a.device)
    if a.shape[-1] != b.shape[-1]:
        raise ValueError(f"embedding dim mismatch: {a.shape[-1]} vs {b.shape[-1]}")
    cos = torch.where(_dead(b)[None, :], -torch.inf, _cosine_matrix(a, b))
    best, idx = torch.amax(cos, dim=1), torch.argmax(cos, dim=1).to(torch.int32)
    dead = _dead(a)
    return torch.where(dead, -1, idx), torch.where(dead, torch.nan, best)


def semantic_coverage(V_a, V_b, *, threshold: float = 0.9, device=None):
    """Share of A's live components whose best match in B has cosine ≥ ``threshold``.

    Dead components of A are left out of the denominator; NaN when A has none.
    """
    _, cos = match_components(V_a, V_b, device)
    live = ~torch.isnan(cos)  # −inf (all of B dead) stays live
    n_live = float(torch.sum(live))
    hits = float(torch.sum(live & (cos >= threshold)))
    return hits / n_live if n_live > 0 else float("nan")


def fastcav(pos_embeds, neg_embeds, device=None):
    """Unit concept activation vector (FastCAV closed form): normalized mean(pos) − mean(neg), (D,)."""
    pos = torch.mean(_f32(pos_embeds, device), dim=0)
    v = pos - torch.mean(_f32(neg_embeds, pos.device), dim=0)
    return v / torch.clamp_min(torch.linalg.vector_norm(v), 1e-12)


def null_calibrated_polysemanticity(V, embedding_table, *, n_null: int = 64, seed: int = 0,
                                    random_state: int = 123, device=None):
    """Polysemanticity z-scored against a random-evidence null (NPI).

    Draws ``n_null`` size-k evidence sets without replacement from the
    embedding table — windows of one permutation when ``n_null·k ≤ N``, one
    permutation per set otherwise — from a ``torch.Generator`` seeded with
    ``seed`` (so the draw differs from the JAX package's), scores them with
    the same clustering, and returns ``(npi (C,), poly (C,), null_mean,
    null_std)``; components whose rows are all zero give NaN.
    """
    V = _f32(V, device)
    table = _f32(embedding_table, V.device)
    if V.ndim != 3 or table.ndim != 2 or V.shape[2] != table.shape[1]:
        raise ValueError(
            f"V must be (C, k, D) and embedding_table (N, D) with matching D; "
            f"got {tuple(V.shape)} and {tuple(table.shape)}"
        )
    n, k = table.shape[0], V.shape[1]
    if n < k:
        raise ValueError(f"embedding table has {n} rows < evidence size {k}")
    generator = torch.Generator().manual_seed(seed)
    if n_null * k <= n:
        ids = torch.randperm(n, generator=generator)[: n_null * k].reshape(n_null, k)
    else:
        ids = torch.stack([torch.randperm(n, generator=generator)[:k] for _ in range(n_null)])
    return _npi_from_null_sets(V, table[ids.to(table.device)], random_state)


def _npi_from_null_sets(V, null_sets, random_state: int = 123):
    """NPI of (C, k, D) ``V`` against drawn (n_null, k, D) ``null_sets``."""
    poly = polysemanticity_score(V, random_state=random_state)
    null_poly = polysemanticity_score(null_sets, random_state=random_state)
    null_mean = torch.mean(null_poly)
    null_std = torch.std(null_poly, correction=0)
    dead = torch.all(V == 0.0, dim=2).all(dim=1)
    npi = torch.where(dead, torch.nan, (poly - null_mean) / (null_std + 1e-12))
    return (npi.cpu().numpy().astype(np.float32), poly.cpu().numpy().astype(np.float32),
            float(null_mean), float(null_std))
