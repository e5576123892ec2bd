"""Concept-quality scores on torch tensors.

Counterpart of ``semanticlens_tpu.scores`` for ``clarity_score``,
``redundancy_score``, ``similarity_score``, ``cosine_probe`` and
``polysemanticity_score``, with the same numerical conventions (all in
float32). Inputs may be tensors (kept on their device) or numpy arrays (put
on ``device``: the CUDA card unless the caller passes ``"cpu"``).

Every cosine matrix goes through :func:`_cosine_matrix`, which is the fused
kernel K1 (:mod:`semanticlens_tpu_torch.ops.cosine`) on the card — the path
by which probing (``cosine_probe``) and ``redundancy_score`` reach it.

Not ported yet (ROADMAP.md): ``topk_cosine_search``, ``soft_wpmi``, ``fastcav`` and
the other scores of the JAX package.
"""

from __future__ import annotations

import logging

import torch

from semanticlens_tpu_torch.ops.cosine import cosine_similarity_matrix
from semanticlens_tpu_torch.ops.kmeans import batched_kmeans
from semanticlens_tpu_torch.utils.device import as_tensor

logger = logging.getLogger(__name__)

__all__ = [
    "clarity_score",
    "redundancy_score",
    "similarity_score",
    "cosine_probe",
    "polysemanticity_score",
]


def _f32(x, device=None) -> torch.Tensor:
    return as_tensor(x, device=device, dtype=torch.float32)


def _normalize(x, dim=-1, eps=1e-12):
    """L2-normalize along ``dim`` (torch.nn.functional.normalize semantics)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def _cosine_matrix(x, y):
    """cos(x_i, y_j) for (..., M, D) × (..., N, D) → (..., M, N): kernel K1 on the card."""
    return cosine_similarity_matrix(x, y)


def clarity_score(V, device=None):
    """Clarity of each concept: how uniform its example embeddings are.

    V : (..., n_samples, n_features) → (...,) in [−1/(n_samples−1), 1].
    """
    V = _f32(V, device)
    n = V.shape[-2]
    mean_embed = torch.mean(_normalize(V), dim=-2)
    return (torch.sum(mean_embed**2, dim=-1) - 1.0 / n) / (n - 1) * n


def redundancy_score(cones, device=None):
    """Mean over components of the max off-diagonal cosine: (..., C, D) → (...,)."""
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
    first ≤10 samples (the reference's empty-cluster fallback).
    """
    V = _f32(V, device)
    centers, _, counts = batched_kmeans(V, n_clusters, n_init=10, seed=random_state)
    poly = 1.0 - clarity_score(centers)
    if replace_empty_clusters:
        degenerate = torch.amin(counts, dim=-1) < 2
        num_samples = min(10, V.shape[1])
        v_mean = torch.mean(V, dim=1)
        pairs = torch.stack([v_mean[:, None].expand(-1, num_samples, -1), V[:, :num_samples]], dim=2)
        fallback = 1.0 - clarity_score(pairs).mean(dim=1)
        poly = torch.where(degenerate, fallback, poly)
    return poly
