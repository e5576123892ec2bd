"""Port parity: ``semanticlens_tpu_torch.ops`` against ``semanticlens_tpu.ops``.

Inputs come from numpy seeds and go through the JAX function (Pallas in
interpret mode on the CPU, as the JAX package's own tests run it) and its
port counterpart on the CPU. Tolerances are stated per test.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu.ops import aggregators as jagg
from semanticlens_tpu.ops import topk as jtopk
from semanticlens_tpu.ops.pallas_ops import cosine_similarity_matrix as j_cosine
from semanticlens_tpu.ops.preprocess import preprocess_images as j_preprocess
from semanticlens_tpu_torch.ops import aggregators as tagg
from semanticlens_tpu_torch.ops import topk as ttopk
from semanticlens_tpu_torch.ops.cosine import cosine_similarity_matrix as t_cosine
from semanticlens_tpu_torch.ops.cosine import launch_counts, reset_launch_counts
from semanticlens_tpu_torch.ops.preprocess import preprocess_images as t_preprocess

torch.set_num_threads(2)


# --------------------------------------------------------------------------- #
# K1: the plain version of the cosine kernel against the Pallas kernel
# (tolerances of tests/ops/test_pallas_ops.py)
# --------------------------------------------------------------------------- #
def _cosine_pair(x, y):
    ours = t_cosine(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    ref = np.asarray(j_cosine(jnp.asarray(x), jnp.asarray(y)))
    return ours, ref


@pytest.mark.parametrize(
    "m, n, d, seed, atol",
    [(5, 7, 64, 0, 2e-5), (300, 513, 128, 1, 3e-5)],
    ids=["small", "tile_spanning"],
)
def test_cosine_plain_matches_pallas(m, n, d, seed, atol):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    y = rng.normal(size=(n, d)).astype(np.float32)
    ours, ref = _cosine_pair(x, y)
    assert ours.shape == ref.shape == (m, n)
    np.testing.assert_allclose(ours, ref, atol=atol)


def test_cosine_zero_rows_give_zero_similarity():
    ours, ref = _cosine_pair(np.zeros((2, 32), np.float32), np.ones((3, 32), np.float32))
    np.testing.assert_allclose(ours, 0.0, atol=1e-6)
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_cosine_self_similarity_diagonal_is_one():
    x = np.random.default_rng(2).normal(size=(10, 16)).astype(np.float32)
    ours, ref = _cosine_pair(x, x)
    np.testing.assert_allclose(np.diag(ours), 1.0, atol=1e-5)
    np.testing.assert_allclose(ours, ref, atol=2e-5)


def test_cosine_batched_rank3_matches_per_slice():
    """Rank-3 inputs (redundancy_score's stacked banks) batch over the leading axis."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 6, 20)).astype(np.float32)
    y = rng.normal(size=(3, 9, 20)).astype(np.float32)
    out = t_cosine(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    for b in range(3):
        np.testing.assert_allclose(out[b], np.asarray(j_cosine(jnp.asarray(x[b]), jnp.asarray(y[b]))),
                                   atol=2e-5)


def test_cosine_wrapper_takes_plain_version_only_for_cpu_tensors():
    reset_launch_counts()
    x = torch.ones(2, 4)
    t_cosine(x, x)
    assert launch_counts()["total"] == 0  # the plain version is never counted
    with pytest.raises(ValueError):
        t_cosine(x.to("meta"), x.to("meta"))


# --------------------------------------------------------------------------- #
# Streaming top-k (bf16 values, −1 sentinels, stable ties)
# --------------------------------------------------------------------------- #
def _both_streams(acts, ids, k, batch):
    c = acts.shape[1]
    js = jtopk.init_topk(c, k)
    ts = ttopk.init_topk(c, k, device="cpu")
    for s in range(0, len(ids), batch):
        js = jtopk.topk_update(js, jnp.asarray(acts[s : s + batch]), jnp.asarray(ids[s : s + batch]))
        ts = ttopk.topk_update(ts, torch.from_numpy(acts[s : s + batch]), torch.from_numpy(ids[s : s + batch]))
    return js, ts


def _assert_state_equal(js, ts):
    np.testing.assert_array_equal(ts.ids.numpy(), np.asarray(js.ids))
    np.testing.assert_array_equal(ts.values.float().numpy(), np.asarray(js.values, np.float32))


@pytest.mark.parametrize(
    "case",
    ["normal", "bf16_ties", "all_negative", "padded_rows"],
)
def test_topk_update_matches_jax(case):
    rng = np.random.default_rng(4)
    n, c, k = 40, 6, 5
    acts = rng.normal(size=(n, c)).astype(np.float32)
    if case == "bf16_ties":
        # Values that collide in bf16 (and exact repeats): the earlier entry must win.
        acts = np.round(acts * 4) / 4 + rng.uniform(0, 1e-4, size=acts.shape).astype(np.float32)
        acts[10:20] = acts[0:10]
    elif case == "all_negative":
        acts = -np.abs(acts) - 0.1  # never displaces a 0.0 sentinel
    elif case == "padded_rows":
        acts[-7:] = -np.inf  # the engine's mask for padded batch rows
    ids = np.arange(n, dtype=np.int32)
    js, ts = _both_streams(acts, ids, k, batch=8)
    _assert_state_equal(js, ts)
    if case in ("all_negative", "padded_rows"):
        dead = np.all(ts.ids.numpy() == -1, axis=1)
        assert dead.all() if case == "all_negative" else not dead.any()


def test_topk_zero_activation_does_not_displace_sentinel():
    acts = np.array([[0.0], [1.0]], np.float32)
    js, ts = _both_streams(acts, np.array([7, 8], np.int32), k=4, batch=2)
    _assert_state_equal(js, ts)
    assert ts.ids.numpy()[0].tolist() == [8, -1, -1, -1]


def test_topk_merge_matches_jax_on_ties():
    rng = np.random.default_rng(5)
    d, c, k = 3, 4, 6
    vals = np.round(rng.normal(size=(d, c, k)) * 2) / 2  # many exact ties
    vals[:, 0] = 0.0  # a row of exact zeros against sentinels
    ids = rng.permutation(d * c * k).reshape(d, c, k).astype(np.int32)
    ids[:, 0, ::2] = -1
    j = jtopk.topk_merge(jtopk.TopKState(jnp.asarray(vals, jnp.bfloat16), jnp.asarray(ids)))
    t = ttopk.topk_merge(ttopk.TopKState(torch.tensor(vals, dtype=torch.bfloat16), torch.from_numpy(ids)))
    _assert_state_equal(j, t)


def test_alive_latents_matches_jax():
    vals = np.zeros((5, 3), np.float32)
    vals[[1, 3], 0] = 1.5
    j = jtopk.alive_latents(jtopk.TopKState(jnp.asarray(vals, jnp.bfloat16), jnp.zeros((5, 3), jnp.int32)))
    t = ttopk.alive_latents(ttopk.TopKState(torch.tensor(vals, dtype=torch.bfloat16),
                                            torch.zeros((5, 3), dtype=torch.int32)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# --------------------------------------------------------------------------- #
# Aggregators (names key cache files — they must match)
# --------------------------------------------------------------------------- #
_AGGS_4D = ["aggregate_conv_mean", "aggregate_conv_sum", "aggregate_conv_max",
            "aggregate_sum_auto", "aggregate_mean_auto", "aggregate_max_auto"]
_AGGS_3D = ["aggregate_transformer_mean", "aggregate_transformer_absmean",
            "aggregate_transformer_max", "aggregate_transformer_absmax",
            "aggregate_transformer_last_token", "aggregate_sum_auto",
            "aggregate_mean_auto", "aggregate_max_auto"]


@pytest.mark.parametrize("name, rank", [(n, 4) for n in _AGGS_4D] + [(n, 3) for n in _AGGS_3D])
def test_aggregators_match_jax(name, rank):
    shape = (3, 5, 4, 7) if rank == 4 else (3, 6, 7)
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    jfn, tfn = getattr(jagg, name), getattr(tagg, name)
    assert tfn.__name__ == jfn.__name__ == name
    np.testing.assert_allclose(tfn(torch.from_numpy(x)).numpy(), np.asarray(jfn(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_special_token_factory_keeps_name_and_rejects_wrong_rank():
    j, t = jagg.get_aggregate_transformer_special_token(2), tagg.get_aggregate_transformer_special_token(2)
    assert t.__name__ == j.__name__
    x = np.random.default_rng(7).normal(size=(2, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(t(torch.from_numpy(x)).numpy(), np.asarray(j(jnp.asarray(x))))
    with pytest.raises(ValueError):
        tagg.aggregate_conv_mean(torch.zeros(2, 3))


# --------------------------------------------------------------------------- #
# Preprocess: antialiased a=-0.5 bicubic, down- and up-scaling
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "shape, size, interpolation",
    [((2, 40, 52, 3), 24, "bicubic"), ((2, 16, 20, 3), 32, "bicubic"), ((1, 33, 33, 3), 17, "bicubic"),
     ((2, 40, 52, 3), 24, "bilinear"), ((2, 16, 20, 3), 32, "bilinear")],
    ids=["down", "up", "down_odd", "bilinear_down", "bilinear_up"],
)
def test_preprocess_matches_jax(shape, size, interpolation):
    """float32 rounding only: atol 1e-5 on normalized values (|x| ≲ 2.2)."""
    u8 = np.random.default_rng(8).integers(0, 256, size=shape, dtype=np.uint8)
    ref = np.asarray(j_preprocess(jnp.asarray(u8), size=size, crop=size, interpolation=interpolation))
    ours = t_preprocess(torch.from_numpy(u8), size=size, crop=size, interpolation=interpolation).numpy()
    assert ours.shape == ref.shape == (shape[0], size, size, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_preprocess_float_input_and_crop_geometry_match_jax():
    img = np.random.default_rng(9).uniform(size=(1, 8, 12, 3)).astype(np.float32)
    ref = np.asarray(j_preprocess(jnp.asarray(img), size=8, crop=6, mean=(0, 0, 0), std=(1, 1, 1)))
    ours = t_preprocess(torch.from_numpy(img), size=8, crop=6, mean=(0, 0, 0), std=(1, 1, 1)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_kmeans_of_one_set_is_batched_kmeans_and_finds_the_jax_clusters():
    """``ops.kmeans`` is ``batched_kmeans`` over one set (the same generator); on three separated blobs it
    finds the JAX ``kmeans`` partition and centers (numbering may differ: other random streams)."""
    from semanticlens_tpu.ops.kmeans import kmeans as j_kmeans
    from semanticlens_tpu_torch.ops import batched_kmeans, kmeans

    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(loc=c, scale=0.05, size=(10, 4)) for c in (-2.0, 0.0, 3.0)]).astype(np.float32)
    centers, labels, counts = kmeans(torch.from_numpy(x), 3)
    b_centers, b_labels, b_counts = batched_kmeans(torch.from_numpy(x)[None], 3)
    assert torch.equal(centers, b_centers[0]) and torch.equal(labels, b_labels[0]) and torch.equal(counts, b_counts[0])
    j_centers, j_labels, j_counts = (np.asarray(a) for a in j_kmeans(jnp.asarray(x), k=3))
    order, j_order = np.argsort(centers[:, 0].numpy()), np.argsort(j_centers[:, 0])
    np.testing.assert_allclose(centers.numpy()[order], j_centers[j_order], atol=1e-5)
    np.testing.assert_array_equal(counts.numpy()[order], j_counts[j_order])
    relabel = {int(o): int(jo) for o, jo in zip(order, j_order)}
    np.testing.assert_array_equal([relabel[int(v)] for v in labels], j_labels)
