"""K1's arithmetic and launch plan on the CPU.

The tiled CUDA kernel of ``semanticlens_tpu_torch/csrc/cosine.cu`` computes
the dot as three TF32 products (3×TF32): each operand is split into
``big = tf32_rna(a)`` and ``small = tf32_rna(a − big)`` and the kernel sums
``small·big + big·small + big·big`` in fp32, with the norms in fp32 from the
raw values. The kernel itself runs only on the card (chip_smoke.py and the
``cuda``-marked tests hold it against its plain version there); here a numpy
emulation of that split is held against the JAX kernel
(``pallas_ops.cosine_similarity_matrix`` in interpret mode) and the JAX
scores' XLA formulation at the reference tolerance, atol 3e-5, on inputs
chosen to stress it, at 1024×1024×512, a size at which one TF32 pass shows
its error. One pass misses that tolerance on the same inputs: that is why
the kernel takes three.

The emulation sums the products in fp32 rounded to nearest. The tensor
cores' accumulator instead truncates each add, an error that grows with D
on near-parallel rows; the kernel bounds it by flushing its partial sums
every 512 of D. The emulation cannot show that error or its cure: the
card's near-duplicate cases up to D=8192 (chip_smoke.py, and
``tests/test_torch_package.py`` at D=4096) cover it.

The launch plan (which kernel, which tile, D padded to a multiple of 4) is
Python, so it is tested here directly.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu.ops.pallas_ops import cosine_similarity_matrix as j_cosine
from semanticlens_tpu.scores import _cosine_matrix as j_cosine_xla
from semanticlens_tpu_torch.ops import cosine as k1

torch.set_num_threads(2)

ATOL = 3e-5  # the JAX package's tolerance for K1 (Precision.HIGHEST reference)
SMS = 132  # streaming multiprocessors of an H100 SXM
M = N = 1024
D = 512


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` with the low 13 bits cleared: a 10-bit mantissa, ties away from zero.

    On the int32 view (sign and magnitude), adding half a TF32 ulp to the
    magnitude bits and truncating rounds the magnitude to nearest, ties away.
    """
    bits = np.ascontiguousarray(a, np.float32).view(np.int32)
    return ((bits + np.int32(0x1000)) & np.int32(-0x2000)).view(np.float32)


def _inv_norm(a: np.ndarray) -> np.ndarray:
    return (1.0 / np.sqrt(np.sum(a * a, axis=-1, dtype=np.float32) + np.float32(1e-24))).astype(np.float32)


def cosine_tf32(x: np.ndarray, y: np.ndarray, passes: int) -> np.ndarray:
    """The tiled kernel's split in float32: 3 passes (3×TF32) or 1 (plain TF32); sums rounded to nearest."""
    xb, yb = tf32_rna(x), tf32_rna(y)
    if passes == 1:
        dots = xb @ yb.T
    else:
        xs, ys = tf32_rna(x - xb), tf32_rna(y - yb)
        dots = (xs @ yb.T + xb @ ys.T) + xb @ yb.T
    return dots * _inv_norm(x)[:, None] * _inv_norm(y)[None, :]


def _inputs(kind: str):
    rng = np.random.default_rng(["gaussian", "near_duplicates", "wide_norms", "zero_rows", "relu"].index(kind))

    def g(*shape):
        return rng.normal(size=shape).astype(np.float32)

    if kind == "gaussian":
        return g(M, D), g(N, D)
    if kind == "near_duplicates":  # a bank whose rows come in pairs y, y + 1e-3·noise (redundancy's max)
        base = g(M // 2, D)
        bank = np.concatenate([base, base + np.float32(1e-3) * g(M // 2, D)])
        return bank, bank
    if kind == "wide_norms":  # row norms spread over 1e-3 .. 1e3
        def scale(rows):
            return (10.0 ** rng.uniform(-3, 3, (rows, 1))).astype(np.float32)

        return g(M, D) * scale(M), g(N, D) * scale(N)
    if kind == "zero_rows":
        x, y = g(M, D), g(N, D)
        x[::7] = 0.0
        y[::5] = 0.0
        return x, y
    return np.maximum(g(M, D), 0.0), np.maximum(g(N, D), 0.0)  # relu: post-activation embeddings


_REFS: dict = {}


def _case(kind: str):
    """Inputs and the two JAX references, computed once per kind."""
    if kind not in _REFS:
        x, y = _inputs(kind)
        pallas = np.asarray(j_cosine(jnp.asarray(x), jnp.asarray(y)))
        xla = np.asarray(j_cosine_xla(jnp.asarray(x), jnp.asarray(y).T))
        _REFS[kind] = (x, y, pallas, xla)
    return _REFS[kind]


KINDS = ["gaussian", "near_duplicates", "wide_norms", "zero_rows", "relu"]


@pytest.mark.parametrize("kind", KINDS)
def test_3xtf32_holds_the_reference_tolerance(kind):
    x, y, pallas, xla = _case(kind)
    ours = cosine_tf32(x, y, passes=3)
    np.testing.assert_allclose(ours, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours, xla, atol=ATOL, rtol=0)
    if kind == "zero_rows":
        assert not ours[::7].any() and not ours[:, ::5].any()


@pytest.mark.parametrize("kind", KINDS)
def test_one_tf32_pass_misses_the_tolerance(kind):
    x, y, pallas, _ = _case(kind)
    assert np.abs(cosine_tf32(x, y, passes=1) - pallas).max() > ATOL


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0**-10  # TF32 spacing in [1, 2)
    a = np.array([1.0, 1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4, 1.0 + 3 * ulp / 4, 0.0, -0.0],
                 np.float32)
    np.testing.assert_array_equal(tf32_rna(a), [1.0, 1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + ulp, 0.0, -0.0])
    v = np.random.default_rng(9).normal(size=4096).astype(np.float32)
    big = tf32_rna(v)
    assert not (big.view(np.int32) & 0x1FFF).any()
    assert np.all(np.abs(big - v) <= np.abs(v) * 2.0**-11)
    residual = v - big - tf32_rna(v - big)
    assert np.all(np.abs(residual) <= np.abs(v) * 2.0**-21)


# --------------------------------------------------------------------------- #
# Launch plan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "m, n, d, variant",
    [
        (8, 1024, 512, "streaming"),  # probe
        (8, 2048, 512, "streaming"),  # probe
        (k1.STREAMING_MAX_M, 2048, 512, "streaming"),  # at the threshold
        (k1.STREAMING_MAX_M + 1, 1024, 512, "tiled"),  # one past it in M
        (k1.STREAMING_MAX_M, 2049, 512, "tiled"),  # one past it in M·N
        (8, 1024, 8192, "tiled"),  # x would not fit the streaming kernel's shared memory
        (1024, 1024, 512, "tiled"),  # redundancy
        (2048, 2048, 512, "tiled"),  # redundancy
    ],
)
def test_plan_picks_the_variant_by_shape(m, n, d, variant):
    assert k1.plan_launch(1, m, n, d, SMS).variant == variant


@pytest.mark.parametrize(
    "m, n, tile",
    [(2048, 2048, (128, 256)), (4096, 8192, (128, 256)), (1024, 1024, (64, 128)), (33, 2048, (64, 128))],
)
def test_plan_picks_the_tile_that_fills_the_card(m, n, tile):
    assert k1.TILE_CONFIGS[k1.plan_launch(1, m, n, 512, SMS).config] == tile


@pytest.mark.parametrize("d, d_pad", [(1, 4), (33, 36), (130, 132), (512, 512), (513, 516)])
def test_plan_pads_d_to_a_multiple_of_4(d, d_pad):
    assert k1.plan_launch(1, 8, 64, d, SMS).d_pad == d_pad
    assert k1.plan_launch(1, 300, 64, d, SMS).d_pad == d_pad


@pytest.mark.parametrize("d", [33, 130, 513])
def test_zero_padding_changes_neither_dots_nor_norms(d):
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(40, d)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(70, d)).astype(np.float32))
    d_pad = k1.plan_launch(1, 40, 70, d, SMS).d_pad
    xp, yp = k1.pad_features(x, d_pad), k1.pad_features(y, d_pad)
    assert xp.shape[-1] == d_pad and torch.equal(xp[:, :d], x) and not xp[:, d:].any()
    # Equal up to the order of the sums: the matmul blocks K differently once it grows (1 ulp at D=513).
    torch.testing.assert_close(k1.cosine_similarity_matrix_plain(xp, yp),
                               k1.cosine_similarity_matrix_plain(x, y), atol=1e-6, rtol=0)


def test_plan_tile_follows_the_sm_count():
    """2048²: one wave of 128×256 tiles on 132 SMs; on 114 (an H100 PCIe) the smaller tile finishes first."""
    assert k1.TILE_CONFIGS[k1.plan_launch(1, 2048, 2048, 512, 132).config] == (128, 256)
    assert k1.TILE_CONFIGS[k1.plan_launch(1, 2048, 2048, 512, 114).config] == (64, 128)


def test_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="grid limit of 65535"):
        k1.plan_launch(70000, 8, 64, 512, SMS)
    with pytest.raises(ValueError, match="tiled kernel's grid limit"):
        k1.plan_launch(1, 10**7, 64, 512, SMS)
    with pytest.raises(ValueError, match="int32"):
        k1.plan_launch(1, 8, 64, 2**31, SMS)


def test_kernel_operand_copies_only_when_it_must():
    x = torch.randn(2, 5, 8)
    assert k1._kernel_operand(x, 5, 8).data_ptr() == x.data_ptr()  # fp32, contiguous, D % 4 == 0
    for a in (x.to(torch.float64), x.transpose(0, 1).contiguous().transpose(0, 1), x[..., :7]):
        out = k1._kernel_operand(a, 5, 8)
        assert out.shape == (2, 5, 8) and out.is_contiguous() and out.dtype == torch.float32
        assert out.data_ptr() != x.data_ptr() or a is x
    torch.testing.assert_close(k1._kernel_operand(x[..., :7], 5, 8)[..., :7], x[..., :7])


def test_a_refused_launch_raises_and_is_not_counted(monkeypatch):
    """A launch that returns an error raises; no count moves (CPU pointers: the fake never reads them)."""
    monkeypatch.setitem(k1._FNS, "tiled", lambda *args: 700)
    monkeypatch.setitem(k1._FNS, "streaming", lambda *args: -2)
    k1.reset_launch_counts()
    x = torch.zeros(1, 8, 8)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        k1._launch_tiled(x, x, x, k1.LaunchPlan("tiled", 8, config=0), 0)
    with pytest.raises(RuntimeError, match="tensor map"):
        k1._launch_streaming(x, x, x, k1.plan_launch(1, 8, 8, 8, SMS), 0)
    assert k1.launch_counts() == {"streaming": 0, "tiled": 0, "total": 0}


def test_launch_counts_sum_and_reset(monkeypatch):
    monkeypatch.setitem(k1._FNS, "tiled", lambda *args: 0)
    monkeypatch.setitem(k1._FNS, "streaming", lambda *args: 0)
    k1.reset_launch_counts()
    x = torch.zeros(1, 8, 8)
    k1._launch_tiled(x, x, x, k1.LaunchPlan("tiled", 8, config=0), 0)
    k1._launch_streaming(x, x, x, k1.plan_launch(1, 8, 8, 8, SMS), 0)
    k1._launch_streaming(x, x, x, k1.plan_launch(1, 8, 8, 8, SMS), 0)
    assert k1.launch_counts() == {"streaming": 2, "tiled": 1, "total": 3}
    k1.cosine_similarity_matrix(x[0], x[0])  # CPU tensors: the plain version, never counted
    k1.reset_launch_counts()
    assert k1.launch_counts() == {"streaming": 0, "tiled": 0, "total": 0}


# --------------------------------------------------------------------------- #
# K1b: the top-k in the tiled kernel's epilogue, by splits and one merge
# --------------------------------------------------------------------------- #
def _dense_topk(sim: torch.Tensor, k: int):
    """The definition: a stable descending sort of the whole score matrix, cut to k."""
    vals, idx = torch.sort(sim, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)


def _k1b_scores(case: str) -> torch.Tensor:
    """A (Q, N) score matrix for a K1b case, Q and N no multiples of the 128 × 256 tile."""
    rng = np.random.default_rng(22)
    if case in ("nan and signed zeros", "few levels"):
        sim = torch.from_numpy(rng.uniform(-1, 1, size=(37, 531)).astype(np.float32))
        if case == "few levels":  # the k-th value tied far beyond k
            return torch.round(sim * 2) / 2
        sim[:, ::7] = torch.where(torch.arange(531)[::7] % 2 == 0, 0.0, -0.0)  # −0.0 and +0.0 are equal values
        sim[3, [5, 300, 17]] = torch.nan  # NaN above every number, the lower column first
        sim[4] = torch.nan
        return sim
    x = rng.normal(size=(131, 24)).astype(np.float32)
    y = rng.normal(size=(777, 24)).astype(np.float32)
    if case == "dead and duplicated rows":
        y[10:60] = y[5]  # 51 copies of one direction: tied scores
        y[300:420] = 0.0  # dead rows all score exactly 0
        x[7] = y[5]
        x[8] = 0.0  # a dead query: every score ties at 0
    return k1.cosine_similarity_matrix_plain(torch.from_numpy(x), torch.from_numpy(y))


@pytest.mark.parametrize("case", ["dead and duplicated rows", "ragged", "nan and signed zeros", "few levels"])
@pytest.mark.parametrize("k, splits, tile", [
    (1, 3, 256),  # k = 1
    (k1.K1B_MAX_K, 2, 256),  # k at its largest
    (7, 3, 64),
    (k1.K1B_MAX_K, 9, 16),  # splits narrower than k
    (5, 1, 256),  # one split
])
def test_k1b_split_selection_and_merge_equal_a_dense_stable_sort(case, k, splits, tile):
    sim = _k1b_scores(case)
    splits = min(splits, math.ceil(sim.shape[1] / tile))
    got = k1.merge_candidates(*k1.topk_candidates_plain(sim, k, splits, tile), k)
    want = _dense_topk(sim, k)
    assert got[1].dtype == torch.int32
    torch.testing.assert_close(got[0], want[0], atol=0, rtol=0, equal_nan=True)
    assert torch.equal(got[1], want[1])


def test_k1b_plain_version_is_k1_then_the_dense_sort():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(50, 36)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(600, 36)).astype(np.float32))
    got = k1.cosine_topk_plain(x, y, 9, splits=3)
    want = _dense_topk(k1.cosine_similarity_matrix_plain(x, y), 9)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k1b_candidates_are_each_splits_ranked_entries_padded():
    sim = torch.tensor([[0.5, 0.1, 0.9, 0.1, -0.2, 0.3, 0.9, 0.0, 0.4, 0.6]])
    vals, cols = k1.topk_candidates_plain(sim, 3, splits=3, tile=3)  # splits [0, 3), [3, 6), [6, 10)
    assert k1.split_bounds(10, 3, 3) == [0, 3, 6, 10]
    assert cols.tolist() == [[2, 0, 1, 5, 3, 4, 6, 9, 8]]
    vals, cols = k1.topk_candidates_plain(sim[:, :7], 3, splits=3, tile=3)  # the last split holds 1 column
    assert cols[0, 6:].tolist() == [6, 2**31 - 1, 2**31 - 1] and vals[0, 7:].tolist() == [-math.inf] * 2


@pytest.mark.parametrize("n, splits, tile", [(1 << 20, 33, 256), (777, 4, 256), (10, 3, 3), (1000, 1, 256)])
def test_k1b_splits_cover_the_columns_in_whole_tiles(n, splits, tile):
    bounds = k1.split_bounds(n, splits, tile)
    assert bounds[0] == 0 and bounds[-1] == n and len(bounds) == splits + 1
    assert all(b % tile == 0 and a < b for a, b in zip(bounds, bounds[1:-1]))
    assert bounds[-2] < n


@pytest.mark.parametrize("m, n, sms, splits", [
    (1024, 1 << 20, SMS, 16),  # the audit search: 8 row blocks × 16 splits, one wave (33 splits, two whole
    #                            waves, lose to the second wave's first tiles)
    (2048, 1000, SMS, 4),  # labeling a 2048-component layer: 16 row blocks, 4 column tiles
    (100, 1 << 20, SMS, 128),  # one row block: one wave; 128 splits of 32 tiles end as soon as 132
    (8192, 8192, SMS, 2),
])
def test_k1b_splits_fill_the_card_in_whole_waves(m, n, sms, splits):
    assert k1.k1b_splits(m, n, sms) == splits


@pytest.mark.parametrize("device, q, n, d, k, takes", [
    ("cuda", 1024, 1 << 20, 512, 32, True),  # the audit search
    ("cpu", 1024, 1 << 20, 512, 32, False),  # the CPU keeps the chunked path
    ("cuda", 1024, 1 << 20, 512, k1.K1B_MAX_K + 1, False),  # k beyond the list
    ("cuda", 2048, 1000, 512, 5, True),  # labeling
    ("cuda", 8, 2048, 512, 5, False),  # few queries against a small bank: the streaming plan
    ("cuda", 8, 1 << 20, 512, 5, True),  # few queries against a large bank: the tiled plan
    ("cuda", 64, 64, 768, 1, True),
    ("cuda", 64, 64, 0, 1, False),  # no features
    ("cuda", 64, 64, 512, 0, False),
])
def test_k1b_is_chosen_by_device_shape_and_k(device, q, n, d, k, takes):
    assert k1.takes_k1b(torch.device(device), q, n, d, k) == takes
    if device == "cuda" and d and 1 <= k <= k1.K1B_MAX_K:
        assert takes == (k1.plan_launch(1, q, n, d, SMS).variant == "tiled")


def test_k1b_constants_match_the_cuda_source():
    source = (Path(k1.__file__).resolve().parent.parent / "csrc" / "cosine.cu").read_text()
    bm, bn = k1.K1B_TILE
    assert f"TOPK_WG = {bm // 64}, TOPK_BN = {bn}, TOPK_STAGES = 4, TOPK_KMAX = {k1.K1B_MAX_K};" in source
    assert f"constexpr int FLUSH_K = {k1.FLUSH_K};" in source
    assert f"X(0, {bm // 64}, {bn}, 4)" in source  # config 0's tile, the one K1b shares


def test_k1b_refuses_cpu_tensors_and_is_not_counted():
    k1.reset_launch_counts()
    x = torch.zeros(40, 8)
    with pytest.raises(ValueError, match="CUDA"):
        k1.cosine_topk_candidates(x, x, 4)
    assert k1.launch_counts()["total"] == 0
