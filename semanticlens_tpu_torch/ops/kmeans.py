"""Batched, seeded k-means on the device.

Counterpart of ``semanticlens_tpu.ops.kmeans``: the same algorithm as
sklearn's — k-means++ seeding with greedy local trials, Lloyd iterations to
a center-shift tolerance, best-inertia restart — run for every neuron and
every restart at once as batched tensor ops. Random numbers come from a
``torch.Generator`` seeded with ``seed``; the streams differ from
``jax.random``'s, so the two packages agree on scores where the clustering
is well determined, not bit for bit.

Every draw is made for all ``total`` neurons of a layer and indexed by the
neuron's position in it, never by how many neurons one call holds: a rank
that clusters rows ``[start, start + m)`` of a component-sharded concept
DB (``rows=(start, total)``) draws what one call over all ``total`` rows
draws for them. The k-means++ candidates are drawn by inverse CDF from
uniforms, so each neuron's draws sit at fixed places in the stream.
"""

from __future__ import annotations

import torch


def _sq_dists(x, centers):
    """‖x_n − c‖² for x (m, n, d) and centers (m, r, k, d) → (m, r, n, k)."""
    xx = torch.sum(x * x, dim=-1)[:, None, :, None]
    cc = torch.sum(centers * centers, dim=-1)[:, :, None, :]
    return (xx - 2.0 * torch.einsum("mnd,mrkd->mrnk", x, centers) + cc).clamp_min(0.0)


def _kmeanspp_init(x, k, n_init, generator, rows: tuple[int, int], n_local_trials: int = 2):
    """k-means++ centers (m, n_init, k, d) for every neuron and restart; ``rows=(start, total)``
    places these m neurons in the layer whose draws the stream holds."""
    m, n, d = x.shape
    start, total = rows
    mine = slice(start, start + m)
    first = torch.randint(0, n, (total, n_init), generator=generator, device=x.device)[mine]
    centers = torch.zeros((m, n_init, k, d), dtype=x.dtype, device=x.device)
    rows = torch.arange(m, device=x.device)[:, None]
    centers[:, :, 0] = x[rows, first]
    d2 = _sq_dists(x, centers[:, :, :1])[..., 0]  # (m, r, n) distance to nearest center
    for c in range(1, k):
        mass = d2.sum(-1, keepdim=True)
        probs = torch.where(mass > 0, d2 / mass.clamp_min(1e-12), torch.full_like(d2, 1.0 / n))
        cdf = torch.cumsum(probs, dim=-1)
        u = torch.rand((total, n_init, n_local_trials), generator=generator, device=x.device)[mine]
        cand = torch.searchsorted(cdf, u * cdf[..., -1:], right=True).clamp_max(n - 1)  # (m, r, t)
        cand_x = x[rows[:, :, None], cand]  # (m, r, t, d)
        new_d2 = torch.minimum(d2[:, :, None, :], _sq_dists(x, cand_x).transpose(-1, -2))
        best = torch.argmin(new_d2.sum(-1), dim=-1)  # (m, r)
        pick = best[..., None, None]
        centers[:, :, c] = torch.gather(cand_x, 2, pick.expand(m, n_init, 1, d))[:, :, 0]
        d2 = torch.gather(new_d2, 2, pick.expand(m, n_init, 1, n))[:, :, 0]
    return centers


def _update(x, centers):
    """One assignment + recentering: (labels, counts, new centers)."""
    labels = torch.argmin(_sq_dists(x, centers), dim=-1)  # (m, r, n)
    one_hot = torch.nn.functional.one_hot(labels, centers.shape[2]).to(x.dtype)  # (m, r, n, k)
    counts = one_hot.sum(2)  # (m, r, k)
    sums = torch.einsum("mrnk,mnd->mrkd", one_hot, x)
    new = torch.where(counts[..., None] > 0, sums / counts.clamp_min(1.0)[..., None], centers)
    return labels, counts, new


def batched_kmeans(V, k: int = 2, *, n_init: int = 10, max_iters: int = 300, seed: int = 123,
                   tol: float = 1e-8, rows: tuple[int, int] | None = None):
    """Seeded k-means independently over the leading axis of ``V`` (m, n, d).

    Returns centers (m, k, d), labels (m, n), counts (m, k), float32 on
    ``V``'s device. Each restart stops once its center shift falls to
    ``tol`` (or after ``max_iters``); the best-inertia restart wins.
    ``rows=(start, total)``: ``V`` is rows ``[start, start + m)`` of a
    ``total``-neuron layer, and gets those rows' draws (default ``(0, m)``).
    """
    x = V.to(torch.float32)
    m, n, d = x.shape
    generator = torch.Generator(device=x.device)
    generator.manual_seed(seed)
    centers = _kmeanspp_init(x, k, n_init, generator, rows or (0, m))
    active = torch.ones((m, n_init), dtype=torch.bool, device=x.device)
    for _ in range(max_iters):
        _, _, new = _update(x, centers)
        shift = torch.sum((new - centers) ** 2, dim=(-1, -2))
        centers = torch.where(active[..., None, None], new, centers)
        active = active & (shift > tol)
        if not bool(active.any()):
            break
    labels, counts, centers = _update(x, centers)
    inertia = torch.gather(_sq_dists(x, centers), 3, labels[..., None])[..., 0].sum(-1)  # (m, r)
    best = torch.argmin(inertia, dim=1)
    rows = torch.arange(m, device=x.device)
    return centers[rows, best], labels[rows, best], counts[rows, best]


def kmeans(x, k: int = 2, *, n_init: int = 10, max_iters: int = 300, seed: int = 123, tol: float = 1e-8):
    """Seeded k-means for a single (n, d) point set: :func:`batched_kmeans` over one set.

    Returns centers (k, d), labels (n,) and counts (k,), float32 on ``x``'s device.
    """
    centers, labels, counts = batched_kmeans(x[None], k, n_init=n_init, max_iters=max_iters, seed=seed, tol=tol)
    return centers[0], labels[0], counts[0]
