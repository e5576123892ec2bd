"""Port parity: ``semanticlens_tpu_torch.scores`` against ``semanticlens_tpu.scores``.

Same numpy inputs through both on the CPU, float32; atol 1e-5 unless stated.
k-means draws from different random streams in the two packages, so the
polysemanticity test uses well-separated clusters (and degenerate neurons
for the empty-cluster fallback), where any k-means++ start converges to the
same partition.
"""

import numpy as np
import pytest
import torch

from semanticlens_tpu import scores as jscores
from semanticlens_tpu_torch import scores as tscores
from semanticlens_tpu_torch.ops.kmeans import batched_kmeans

torch.set_num_threads(2)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("shape", [(6, 5, 16), (3, 4, 7, 8)], ids=["rank3", "rank4"])
def test_clarity_matches_jax(shape):
    V = _rng(0).normal(size=shape).astype(np.float32)
    np.testing.assert_allclose(tscores.clarity_score(V, device="cpu").numpy(),
                               np.asarray(jscores.clarity_score(V)), atol=1e-5)


@pytest.mark.parametrize("shape", [(9, 16), (3, 7, 16)], ids=["rank2", "rank3"])
def test_redundancy_matches_jax(shape):
    cones = _rng(1).normal(size=shape).astype(np.float32)
    cones[..., 2, :] = cones[..., 0, :] * 3.0  # an exact duplicate direction
    np.testing.assert_allclose(tscores.redundancy_score(cones, device="cpu").numpy(),
                               np.asarray(jscores.redundancy_score(cones)), atol=1e-5)


@pytest.mark.parametrize(
    "xs, ys",
    [((4, 8), (6, 8)), ((4, 8), (8, 6)), ((5, 8), (5, 8))],
    ids=["x_yT", "x_y_quirk", "elementwise"],
)
def test_similarity_dispatch_matches_jax(xs, ys):
    rng = _rng(2)
    x = rng.normal(size=xs).astype(np.float32)
    y = rng.normal(size=ys).astype(np.float32)
    np.testing.assert_allclose(tscores.similarity_score(x, y, device="cpu").numpy(),
                               np.asarray(jscores.similarity_score(x, y)), atol=1e-5)


def test_cosine_probe_matches_jax_and_checks_dims():
    rng = _rng(3)
    q = rng.normal(size=(3, 12)).astype(np.float32)
    db = rng.normal(size=(12, 12)).astype(np.float32)  # square: the unambiguous primitive
    np.testing.assert_allclose(tscores.cosine_probe(q, db, device="cpu").numpy(),
                               np.asarray(jscores.cosine_probe(q, db)), atol=1e-5)
    with pytest.raises(ValueError):
        tscores.cosine_probe(q, db[:, :5], device="cpu")


def _two_cluster_concepts(n_neurons=6, n_samples=12, d=16, seed=4):
    """Per neuron: two tight clusters around random directions (+ one degenerate neuron)."""
    rng = _rng(seed)
    V = np.empty((n_neurons, n_samples, d), np.float32)
    for i in range(n_neurons):
        a, b = rng.normal(size=(2, d)) * 5.0
        split = rng.integers(3, n_samples - 3)
        V[i, :split] = a + 0.01 * rng.normal(size=(split, d))
        V[i, split:] = b + 0.01 * rng.normal(size=(n_samples - split, d))
    V[-1] = V[-1, :1] + 0.01 * rng.normal(size=(n_samples, d))  # one blob: k-means splits noise
    return V


def test_polysemanticity_matches_jax_on_separated_clusters():
    """atol 1e-4: identical partitions, centers differ only in summation order."""
    V = _two_cluster_concepts()[:-1]
    ours = tscores.polysemanticity_score(V, device="cpu").numpy()
    ref = np.asarray(jscores.polysemanticity_score(V))
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_polysemanticity_empty_cluster_fallback_matches_jax():
    """A neuron of identical samples leaves one cluster empty → the fallback formula."""
    V = _two_cluster_concepts()
    V[0] = V[0, :1]  # exact repeats: every point lands in one cluster
    ours = tscores.polysemanticity_score(V, device="cpu").numpy()
    ref = np.asarray(jscores.polysemanticity_score(V))
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-5)
    np.testing.assert_allclose(ours[:-1], ref[:-1], atol=1e-4)
    assert np.isfinite(ours).all()


def test_batched_kmeans_recovers_partition_and_is_seeded():
    V = torch.from_numpy(_two_cluster_concepts()[:-1])
    centers, labels, counts = batched_kmeans(V, 2, seed=7)
    assert centers.shape == (5, 2, 16) and labels.shape == (5, 12) and counts.shape == (5, 2)
    assert (counts.sum(-1) == 12).all()
    for i in range(5):  # each true cluster maps to exactly one label
        lab = labels[i].numpy()
        first = lab[0]
        split = int((np.linalg.norm(V[i].numpy() - V[i, 0].numpy(), axis=1) < 1.0).sum())
        assert (lab[:split] == first).all() and (lab[split:] != first).all()
    again = batched_kmeans(V, 2, seed=7)
    assert all(torch.equal(a, b) for a, b in zip((centers, labels, counts), again))
