"""Port parity of the Analyze stage: README step 5 (naming components) and the audit scores.

Each function of ``semanticlens_tpu_torch.scores`` / ``.lens`` added for the
audit path runs against its JAX twin on the same seeded numpy inputs on the
CPU (the port takes K1's plain version there). Tolerances: cosines atol
1e-5, soft-WPMI atol 1e-4; others are stated where they are used. The
foundation-model tests use a cut-down CLIP with the same numpy weights in
both packages (the port's through ``convert.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semanticlens_tpu import lens as jlens
from semanticlens_tpu import scores as jscores
from semanticlens_tpu.foundation_models import clip as jclip
from semanticlens_tpu.foundation_models.tokenizer import HashTokenizer as JHash
from semanticlens_tpu_torch import lens as tlens
from semanticlens_tpu_torch import scores as tscores
from semanticlens_tpu_torch.foundation_models import clip as tclip
from semanticlens_tpu_torch.ops import cosine as k1
from semanticlens_tpu_torch.utils.profiling import counters, reset

torch.set_num_threads(2)

TINY_J = jclip.CLIPConfig(
    embed_dim=16,
    vision=jclip.VisionCfg(kind="vit", image_size=16, patch_size=8, width=32, layers=2, heads=2),
    text=jclip.TextCfg(context_length=12, vocab_size=50, width=32, heads=2, layers=2),
)
TINY_T = tclip.CLIPConfig(
    embed_dim=16,
    vision=tclip.VisionCfg(image_size=16, patch_size=8, width=32, layers=2, heads=2),
    text=tclip.TextCfg(context_length=12, vocab_size=50, width=32, heads=2, layers=2),
)
VOCAB = [f"word{i}" for i in range(37)] + ["dog", "cat", "red car"]
TEMPLATES = ["a photo of a {}", "{} in the wild"]


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.fixture(scope="module")
def fms():
    np_clip = tclip.init_clip_params_jax_layout(1, TINY_T)
    jfm = jclip.OpenClip("ViT-B-32", params={k: jnp.asarray(v) for k, v in np_clip.items()}, dtype=jnp.float32)
    jfm.cfg, jfm.tokenizer = TINY_J, JHash(50, 12)
    tfm = tclip.OpenClip("ViT-B-32", jax_params=np_clip, dtype=torch.float32, device="cpu", cfg=TINY_T)
    return jfm, tfm


# --------------------------------------------------------------------------- #
# topk_cosine_search
# --------------------------------------------------------------------------- #
def _ties_bank(n=203, d=16, seed=0):
    """Components with exact duplicates and dead (zero) rows: many exact ties."""
    bank = _rng(seed).normal(size=(n, d)).astype(np.float32)
    bank[10:30] = bank[5]  # 21 copies of one direction
    bank[40:60] = 0.0  # dead rows all score exactly 0
    return bank


@pytest.mark.parametrize("k, chunk_size", [(1, 64), (7, 64), (25, 50), (32, 1000), (60, 64)])
def test_topk_cosine_search_matches_jax_with_ties_and_ragged_chunks(k, chunk_size):
    """203 rows in chunks of 64 / 50 leave a ragged last chunk; duplicated rows and
    zero rows tie exactly, so the ids hold the tie order (lower index first)."""
    bank = _ties_bank()
    queries = np.concatenate([bank[[5, 45]], _rng(1).normal(size=(4, 16)).astype(np.float32)])
    queries[1] = -queries[0]  # its best matches are the zero rows (0) after the negatives run out
    tv, ti = tscores.topk_cosine_search(queries, bank, k, chunk_size=chunk_size, device="cpu")
    jv, ji = jscores.topk_cosine_search(queries, bank, k, chunk_size=chunk_size)
    assert ti.dtype == torch.int32 and tv.shape == (6, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def test_topk_cosine_search_equals_dense_stable_sort_and_checks_k():
    bank = _ties_bank()
    queries = bank[[5, 45, 7]]
    dense = tscores.cosine_probe(queries, bank, device="cpu")
    order = torch.sort(dense, dim=1, descending=True, stable=True).indices[:, :40]
    _, idx = tscores.topk_cosine_search(queries, bank, 40, chunk_size=17, device="cpu")
    np.testing.assert_array_equal(idx.numpy(), order.numpy())
    assert idx[0, :21].tolist() == [5, *range(10, 30)]  # the tied copies, in index order
    with pytest.raises(ValueError, match="exceeds"):
        tscores.topk_cosine_search(queries, bank[:3], 4, device="cpu")


@pytest.mark.parametrize("n_queries, k, fused", [
    (40, 7, True),  # more queries than the streaming kernel takes: the tiled plan
    (40, 1, True),
    (40, k1.K1B_MAX_K, True),
    (40, k1.K1B_MAX_K + 1, False),  # k beyond K1b's list
    (8, 7, False),  # few queries against a small bank: the streaming plan
])
def test_topk_cosine_search_takes_k1b_by_shape_and_k(monkeypatch, n_queries, k, fused):
    """On a card (emulated here: the rule told the device is CUDA, K1b's launch replaced by its plain version
    with 64-wide tiles, so the splits are many), the search takes K1b exactly where the rule says, counts it
    once a call, and gives the dense stable sort's answer on either path, ties included."""
    calls = []

    def plain_k1b(x, y, kk):
        calls.append(kk)
        splits = k1.k1b_splits(x.shape[0], y.shape[0], 132)
        return k1.topk_candidates_plain(k1.cosine_similarity_matrix_plain(x, y), kk, splits, tile=64)

    monkeypatch.setattr(tscores, "cosine_topk_candidates", plain_k1b)
    monkeypatch.setattr(tscores, "takes_k1b", lambda device, *shape: k1.takes_k1b(torch.device("cuda"), *shape))
    bank = _ties_bank()
    queries = np.concatenate([bank[[5, 45]], _rng(2).normal(size=(n_queries - 2, 16)).astype(np.float32)])
    reset("search.k1b")
    vals, idx = tscores.topk_cosine_search(queries, bank, k, chunk_size=64, device="cpu")
    assert calls == ([k] if fused else [])
    assert counters().get("search.k1b", 0) == int(fused)
    dense = tscores.cosine_probe(queries, bank, device="cpu")
    want = torch.sort(dense, dim=1, descending=True, stable=True)
    assert idx.dtype == torch.int32 and vals.shape == (n_queries, k)
    np.testing.assert_array_equal(idx.numpy(), want.indices[:, :k].numpy())
    torch.testing.assert_close(vals, want.values[:, :k], atol=1e-6, rtol=0)


def _sort_merge(best_vals, best_idx, sim, start):
    """The merge by definition: a stable descending sort of the state, then the block, cut to k."""
    k = best_vals.shape[1]
    col = torch.arange(start, start + sim.shape[1], dtype=torch.int32)
    all_vals = torch.cat([best_vals, sim], dim=1)
    all_idx = torch.cat([best_idx, col[None, :].expand(sim.shape[0], -1)], dim=1)
    vals, order = torch.sort(all_vals, dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(all_idx, 1, order[:, :k])


@pytest.mark.parametrize("blocks", ["continuous", "ties above the cut", "ties at the cut", "signed zeros"])
def test_merge_topk_equals_a_stable_sort_merge(blocks):
    """Each chunk's selection (torch.topk, or the stable sort when the k-th value is tied
    beyond what topk took) merged over 4 chunks, one ragged, equals the sort merge."""
    rng = _rng(3)
    k, widths = 6, [40, 40, 40, 3]
    chunks = [torch.from_numpy(rng.uniform(-1, 1, size=(5, w)).astype(np.float32)) for w in widths]
    for c in chunks:
        if blocks == "ties above the cut":  # the row's best value twice, in every chunk
            c[:, 0] = c[:, -1] = c.max(dim=1).values + 1.0
        elif blocks == "ties at the cut":  # a few levels only: the k-th value is tied
            c.copy_(torch.round(c * 2) / 2)
        elif blocks == "signed zeros":  # −0.0 and +0.0 are equal values
            c[:, ::2] = torch.where(torch.arange(c.shape[1])[::2] % 4 == 0, 0.0, -0.0)
            c[:, 1::2] = -1.0
    got = ref = (torch.full((5, k), -torch.inf), torch.full((5, k), -1, dtype=torch.int32))
    start = 0
    for c in chunks:
        got = tscores._merge_topk(*got, c, start)
        ref = _sort_merge(*ref, c, start)
        start += c.shape[1]
    assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])


# --------------------------------------------------------------------------- #
# class_composition, soft-WPMI
# --------------------------------------------------------------------------- #
def test_class_composition_matches_jax():
    ids = _rng(2).integers(-1, 50, size=(12, 6))
    ids[3] = -1  # no evidence: purity 0
    labels = _rng(3).integers(0, 5, size=50)
    for n_classes in (None, 7):
        t_counts, t_purity = tscores.class_composition(ids, labels, n_classes)
        j_counts, j_purity = jscores.class_composition(ids, labels, n_classes)
        np.testing.assert_array_equal(t_counts, j_counts)
        np.testing.assert_array_equal(t_purity, j_purity)
    assert t_purity[3] == 0.0


def _wpmi_inputs(seed=4, n=300, v=40, d=16, c=30, k=8):
    rng = _rng(seed)
    vocab = rng.normal(size=(v, d)).astype(np.float32)
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(0, n, size=(c, k))
    ids[2, 5:] = -1  # a partly filled row
    ids[7] = -1  # a row with no evidence
    ids[9, :4] = ids[9, 4]  # repeated evidence ids
    return vocab, table, ids


@pytest.mark.parametrize("kwargs", [{}, {"temperature": 30.0, "lam": 0.5, "chunk": 7}],
                         ids=["defaults", "temperature30-lam0.5-chunk7"])
def test_soft_wpmi_matches_jax(kwargs):
    """atol 1e-4."""
    vocab, table, ids = _wpmi_inputs()
    t = tscores.soft_wpmi(vocab, table, ids, device="cpu", **kwargs)
    j = jscores.soft_wpmi(vocab, table, ids, **kwargs)
    assert t.dtype == np.float32 and t.shape == (30, 40)
    np.testing.assert_allclose(t, j, atol=1e-4)


def test_soft_wpmi_invariant_to_sentinel_padding_and_chunk_size():
    """Extra −1 columns carry zero weight and the image/component chunking changes nothing
    (atol 1e-5: only the order of float32 sums differs)."""
    vocab, table, ids = _wpmi_inputs(n=5000)  # past one 4096-row image chunk
    base = tscores.soft_wpmi(vocab, table, ids, device="cpu")
    padded = np.concatenate([ids, np.full((ids.shape[0], 5), -1)], axis=1)
    np.testing.assert_allclose(tscores.soft_wpmi(vocab, table, padded, device="cpu"), base, atol=1e-5)
    for chunk in (1, 13, 4097):
        np.testing.assert_allclose(tscores.soft_wpmi(vocab, table, ids, chunk=chunk, device="cpu"), base,
                                   atol=1e-5)
    np.testing.assert_array_equal(tscores.soft_wpmi(vocab, table, np.full((3, 4), -1), device="cpu"),
                                  np.zeros((3, 40), np.float32))


def test_soft_wpmi_rejects_bad_evidence():
    vocab, table, ids = _wpmi_inputs()
    with pytest.raises(ValueError, match="out of range"):
        tscores.soft_wpmi(vocab, table, ids + 300, device="cpu")
    with pytest.raises(ValueError, match=r"\(C, k\)"):
        tscores.soft_wpmi(vocab, table, ids[0], device="cpu")


# --------------------------------------------------------------------------- #
# drift, match, coverage, fastcav
# --------------------------------------------------------------------------- #
def _db_pair(seed=5):
    rng = _rng(seed)
    a = rng.normal(size=(20, 4, 16)).astype(np.float32)
    b = a + 0.3 * rng.normal(size=a.shape).astype(np.float32)
    a[3] = 0.0  # dead in A
    b[6] = 0.0  # dead in B
    b[8] = b[9]  # two equal best matches: the first wins
    return a, b


def test_drift_score_matches_jax_with_dead_rows():
    a, b = _db_pair()
    t = tscores.drift_score(a, b, device="cpu").numpy()
    j = np.asarray(jscores.drift_score(a, b))
    assert np.isnan(t[3]) and np.isnan(t[6])
    np.testing.assert_allclose(t, j, atol=1e-5)
    np.testing.assert_allclose(tscores.drift_score(a.mean(1), a, device="cpu").numpy()[~np.isnan(t)], 0.0,
                               atol=1e-6)  # (C, D) and (C, k, D) inputs aggregate alike
    with pytest.raises(ValueError, match="mismatch"):
        tscores.drift_score(a, b[:5], device="cpu")


def test_match_components_matches_jax():
    a, b = _db_pair()
    b_agg = b.mean(1)
    a_agg = np.concatenate([a.mean(1), b_agg[[8]]])  # its match ties between rows 8 and 9 of B
    t_idx, t_cos = tscores.match_components(a_agg, b, device="cpu")
    j_idx, j_cos = jscores.match_components(a_agg, b)
    assert t_idx.dtype == torch.int32
    t_idx, t_cos = t_idx.numpy(), t_cos.numpy()
    np.testing.assert_array_equal(t_idx, np.asarray(j_idx))
    np.testing.assert_allclose(t_cos, np.asarray(j_cos), atol=1e-5)
    assert t_idx[3] == -1 and np.isnan(t_cos[3]) and t_idx[-1] == 8
    assert 6 not in t_idx  # a dead row of B is never a match
    all_dead = tscores.match_components(a, np.zeros_like(b), device="cpu")[1].numpy()
    assert np.isneginf(all_dead[[0, 1]]).all() and np.isnan(all_dead[3])
    with pytest.raises(ValueError, match="dim"):
        tscores.match_components(a, b[..., :8], device="cpu")


@pytest.mark.parametrize("threshold", [0.5, 0.9, 0.99])
def test_semantic_coverage_matches_jax(threshold):
    a, b = _db_pair()
    t = tscores.semantic_coverage(a, b, threshold=threshold, device="cpu")
    assert t == pytest.approx(jscores.semantic_coverage(a, b, threshold=threshold), abs=1e-6)
    assert np.isnan(tscores.semantic_coverage(np.zeros_like(a), b, device="cpu"))


def test_fastcav_matches_jax():
    rng = _rng(6)
    pos, neg = rng.normal(size=(9, 16)).astype(np.float32) + 1.0, rng.normal(size=(13, 16)).astype(np.float32)
    t = tscores.fastcav(pos, neg, device="cpu").numpy()
    np.testing.assert_allclose(t, np.asarray(jscores.fastcav(pos, neg)), atol=1e-6)
    assert np.linalg.norm(t) == pytest.approx(1.0, abs=1e-6)


# --------------------------------------------------------------------------- #
# Null-calibrated polysemanticity and the k-means random streams
# --------------------------------------------------------------------------- #
def _npi_inputs(seed=7, c=6, k=6, n=40, d=8):
    """Evidence sets of two tight clusters, and a table whose rows sit near two orthogonal
    points, so every 2-means partition the clustering can find is fixed by the data."""
    rng = _rng(seed)
    centers = np.zeros((2, d), np.float32)
    centers[0, 0] = centers[1, 1] = 5.0
    V = centers[np.arange(k) % 2] + 0.05 * rng.normal(size=(c, k, d)).astype(np.float32)
    V[1] = 0.0  # a dead component
    table = centers[rng.integers(0, 2, size=n)] + 0.01 * rng.normal(size=(n, d)).astype(np.float32)
    return V, table


def _jax_null_sets(table, n_null, k, seed):
    """The JAX package's draw (scores.py, null_calibrated_polysemanticity)."""
    n = table.shape[0]
    key = jax.random.PRNGKey(seed)
    if n_null * k <= n:
        ids = jax.random.permutation(key, n)[: n_null * k].reshape(n_null, k)
    else:
        ids = jax.vmap(lambda kk: jax.random.permutation(kk, n)[:k])(jax.random.split(key, n_null))
    return table[np.asarray(ids)]


@pytest.mark.parametrize("n_null", [6, 16], ids=["one-permutation", "per-set"])
def test_npi_on_jax_null_draw_matches_jax(n_null):
    """The port's NPI after the draw, fed JAX's null sets: poly, null mean and std atol 1e-4
    (near-duplicate rows in a one-sided null set leave the split of a 0.01-wide blob to the
    random stream: ≈1e-5 of poly), NPI atol 1e-3 (divided by the null std)."""
    V, table = _npi_inputs()
    j_npi, j_poly, j_mean, j_std = jscores.null_calibrated_polysemanticity(V, table, n_null=n_null, seed=3)
    null_sets = _jax_null_sets(table, n_null, V.shape[1], 3)
    t_npi, t_poly, t_mean, t_std = tscores._npi_from_null_sets(torch.from_numpy(V), torch.from_numpy(null_sets))
    np.testing.assert_allclose(t_poly, j_poly, atol=1e-4)
    assert t_mean == pytest.approx(j_mean, abs=1e-4) and t_std == pytest.approx(j_std, abs=1e-4)
    assert np.isnan(t_npi[1]) and np.isnan(j_npi[1])
    np.testing.assert_allclose(t_npi, j_npi, atol=1e-3)


def test_npi_draw_rule_and_determinism(monkeypatch):
    """Windows of one permutation when n_null·k ≤ N (no row twice), one permutation per
    set otherwise (no row twice within a set); the same seed gives the same draw."""
    V, _ = _npi_inputs()
    table = np.arange(40 * 8, dtype=np.float32).reshape(40, 8) + 1.0  # row i is recognisable
    seen = []
    real = tscores._npi_from_null_sets
    monkeypatch.setattr(tscores, "_npi_from_null_sets",
                        lambda v, null, rs=123: seen.append(null[..., 0].numpy().copy()) or real(v, null, rs))
    out = tscores.null_calibrated_polysemanticity(V, table, n_null=6, seed=1, device="cpu")
    again = tscores.null_calibrated_polysemanticity(V, table, n_null=6, seed=1, device="cpu")
    tscores.null_calibrated_polysemanticity(V, table, n_null=16, seed=1, device="cpu")
    assert np.unique(seen[0]).size == 36  # 6 disjoint windows of 6
    np.testing.assert_array_equal(seen[0], seen[1])
    np.testing.assert_array_equal(out[0], again[0])
    assert all(np.unique(row).size == 6 for row in seen[2]) and np.unique(seen[2]).size < 96
    with pytest.raises(ValueError, match="rows < evidence"):
        tscores.null_calibrated_polysemanticity(V, table[:5], device="cpu")
    with pytest.raises(ValueError, match="matching D"):
        tscores.null_calibrated_polysemanticity(V, table[:, :4], device="cpu")


@pytest.mark.parametrize("shape", [(64, 25, 32), (128, 10, 64), (64, 50, 16)])
def test_polysemanticity_kmeans_stream_gap_on_gaussian_sets(shape):
    """Ill-separated concept sets (i.i.d. Gaussian rows, what NPI's null sets are): the two
    packages' k-means draw from different random streams, so single components can differ a
    lot (0.21–0.59 measured) but the layer stays close. Bound: mean |Δ| over components
    ≤ 0.1 (measured 0.026–0.064) and |Δ| of the layer mean ≤ 0.02 (measured ≤ 0.0096)."""
    V = _rng(sum(shape)).normal(size=shape).astype(np.float32)
    j = np.asarray(jscores.polysemanticity_score(V))
    t = tscores.polysemanticity_score(V, device="cpu").numpy()
    diff = np.abs(t - j)
    assert np.isfinite(t).all() and diff.mean() <= 0.1
    assert abs(t.mean() - j.mean()) <= 0.02


# --------------------------------------------------------------------------- #
# Lens: label_components, _embed_vocabulary, cav_probing
# --------------------------------------------------------------------------- #
def test_embed_vocabulary_matches_jax(fms):
    """Template-outer pairing, not the (q t) quirk of text probing (atol 1e-5)."""
    jfm, tfm = fms
    for templates in (None, TEMPLATES):
        t = tlens._embed_vocabulary(tfm, VOCAB, templates, 7).numpy()
        j = np.asarray(jlens._embed_vocabulary(jfm, VOCAB, templates, 7))
        np.testing.assert_allclose(t, j, atol=1e-5)
    quirk = tlens._embed_text_probes(tfm, VOCAB, TEMPLATES, None).numpy()
    assert not np.allclose(quirk, t, atol=1e-3)


@pytest.mark.parametrize("templates", [None, TEMPLATES], ids=["plain", "templates"])
def test_label_components_cosine_matches_jax(fms, templates):
    jfm, tfm = fms
    db = {"a": _rng(8).normal(size=(30, 16)).astype(np.float32),
          "b": _rng(9).normal(size=(11, 3, 16)).astype(np.float32).mean(1)}
    t = tlens.label_components(tfm, VOCAB, db, top_m=4, templates=templates)
    j = jlens.label_components(jfm, VOCAB, db, top_m=4, templates=templates)
    for layer in db:
        assert t[layer][0] == j[layer][0]
        np.testing.assert_allclose(t[layer][1], j[layer][1], atol=1e-5)
    words, scores = tlens.label_components(tfm, VOCAB[:3], db["a"], top_m=9)  # top_m capped at |V|
    assert len(words[0]) == 3 and scores.shape == (30, 3) and scores.dtype == np.float32


def test_label_components_wpmi_matches_jax(fms):
    """atol 1e-4 on the soft-WPMI scores; the named words are equal."""
    jfm, tfm = fms
    _, table, ids = _wpmi_inputs(seed=10, c=12)
    bank = _rng(11).normal(size=(12, 16)).astype(np.float32)
    kw = dict(top_m=3, scoring="wpmi", image_embeds=table, templates=TEMPLATES)
    t = tlens.label_components(tfm, VOCAB, {"a": bank}, evidence_ids={"a": ids}, **kw)
    j = jlens.label_components(jfm, VOCAB, {"a": bank}, evidence_ids={"a": ids}, **kw)
    assert t["a"][0] == j["a"][0]
    np.testing.assert_allclose(t["a"][1], j["a"][1], atol=1e-4)
    bare = tlens.Lens(tfm).label_components(VOCAB, bank, evidence_ids=ids, temperature=5.0, **kw)
    jbare = jlens.Lens(jfm).label_components(VOCAB, bank, evidence_ids=ids, temperature=5.0, **kw)
    np.testing.assert_allclose(bare[1], jbare[1], atol=1e-4)


def test_label_components_validation_errors(fms):
    _, tfm = fms
    bank = _rng(12).normal(size=(5, 16)).astype(np.float32)
    ids = np.zeros((5, 2), np.int64)
    table = np.ones((3, 16), np.float32)
    cases = [
        (dict(vocabulary=[]), "non-empty"),
        (dict(scoring="bm25"), "scoring must be"),
        (dict(vocab_embeds=np.ones((2, 16), np.float32)), "rows for"),
        (dict(scoring="wpmi"), "needs evidence_ids"),
        (dict(scoring="wpmi", evidence_ids=ids[:4], image_embeds=table), "does not match"),
        (dict(db={"a": bank}, scoring="wpmi", evidence_ids=ids, image_embeds=table), "dict for a dict DB"),
        (dict(db={"a": bank, "b": bank}, scoring="wpmi", evidence_ids={"a": ids}, image_embeds=table),
         "missing layers"),
    ]
    for kwargs, match in cases:
        db = kwargs.pop("db", bank)
        vocab = kwargs.pop("vocabulary", VOCAB[:5])
        with pytest.raises(ValueError, match=match):
            tlens.label_components(tfm, vocab, db, **kwargs)


def test_cav_probing_matches_jax(fms):
    """atol 1e-4: the tiny towers' parity tolerance, through the image tower."""
    jfm, tfm = fms
    rng = _rng(13)
    pos = rng.integers(0, 256, size=(5, 20, 24, 3), dtype=np.uint8)
    neg = rng.integers(0, 256, size=(7, 20, 24, 3), dtype=np.uint8)
    db = {"a": rng.normal(size=(9, 16)).astype(np.float32)}
    t = tlens.Lens(tfm).cav_probing(pos, neg, db)
    j = jlens.Lens(jfm).cav_probing(pos, neg, db)
    assert t["a"].shape == (1, 9)
    np.testing.assert_allclose(t["a"], np.asarray(j["a"]), atol=1e-4)


# --------------------------------------------------------------------------- #
# The slice as a whole
# --------------------------------------------------------------------------- #
def test_audit_path_on_a_port_concept_db_matches_jax(fms, tmp_path):
    """README step 5 on the port's own Collect+Embed output: a ResNet-18 quickstart run by
    the port (with sweep checkpoints on), then both packages' Lens name its components
    (cosine and soft-WPMI from the collected evidence and embedding table) and score it
    (match, coverage, drift, NPI on JAX's draw) on the same inputs."""
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean
    from semanticlens_tpu_torch.utils import make_preprocess_fn

    jfm, tfm = fms
    images = _rng(14).integers(0, 256, size=(14, 40, 48, 3), dtype=np.uint8)
    model = ResNet(depth=18, dtype=torch.float32, device="cpu")
    model.params, model.name = model.init(seed=0), "resnet18-toy"
    dataset = ArrayDataset(images, name="toy")
    cv = ActivationComponentVisualizer(model, dataset, dataset, ["layer3", "layer4"], 4,
                                       aggregate_fn=aggregate_conv_mean, cache_dir=str(tmp_path),
                                       model_preprocess=make_preprocess_fn(size=32))
    lens, jl = tlens.Lens(tfm), jlens.Lens(jfm)
    db = lens.compute_concept_db(cv, batch_size=4, checkpoint=8)
    assert not (cv.storage_dir / "_checkpoint-fused").exists()
    agg = {k: v.mean(1) for k, v in db.items()}
    evidence = {k: cv.get_max_reference(k) for k in db}
    table = cv.embedding_table

    t_cos, j_cos = lens.label_components(VOCAB, agg, top_m=3), jl.label_components(VOCAB, agg, top_m=3)
    kw = dict(top_m=3, scoring="wpmi", evidence_ids=evidence, image_embeds=table)
    t_wpmi, j_wpmi = lens.label_components(VOCAB, agg, **kw), jl.label_components(VOCAB, agg, **kw)
    for layer in db:
        assert t_cos[layer][0] == j_cos[layer][0] and t_wpmi[layer][0] == j_wpmi[layer][0]
        np.testing.assert_allclose(t_cos[layer][1], j_cos[layer][1], atol=1e-5)
        np.testing.assert_allclose(t_wpmi[layer][1], j_wpmi[layer][1], atol=1e-4)

    # 14 images, 4 samples: many components share their evidence (in another order), so B
    # has rows equal up to the last bit of their mean; their cosines tie up to float32
    # rounding and either copy is the match. Elsewhere the ids are equal.
    t_idx, t_match = tscores.match_components(agg["layer3"], agg["layer4"], device="cpu")
    j_idx, j_match = jscores.match_components(agg["layer3"], agg["layer4"])
    t_idx, j_idx = t_idx.numpy(), np.asarray(j_idx)
    differ = t_idx != j_idx
    np.testing.assert_allclose(agg["layer4"][t_idx[differ]], agg["layer4"][j_idx[differ]], atol=1e-6)
    np.testing.assert_allclose(t_match.numpy(), np.asarray(j_match), atol=1e-5)
    assert tscores.semantic_coverage(agg["layer3"], agg["layer4"], device="cpu") == pytest.approx(
        jscores.semantic_coverage(agg["layer3"], agg["layer4"]), abs=1e-6)
    drift = tscores.drift_score(db["layer4"], db["layer4"], device="cpu").numpy()
    np.testing.assert_allclose(drift[~np.isnan(drift)], 0.0, atol=1e-6)
    np.testing.assert_array_equal(np.isnan(drift), np.abs(agg["layer4"]).sum(1) == 0)

    null_sets = _jax_null_sets(table, 3, 4, 0)
    j_npi = jscores.null_calibrated_polysemanticity(db["layer4"][:8], table, n_null=3, seed=0)
    t_npi = tscores._npi_from_null_sets(torch.from_numpy(db["layer4"][:8]), torch.from_numpy(null_sets))
    assert t_npi[0].shape == (8,) and np.isfinite(t_npi[1]).all()
    assert t_npi[3] >= 0.0 and np.isfinite(j_npi[3])
