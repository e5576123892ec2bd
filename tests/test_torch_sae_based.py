"""Port parity: SAE latents audited as components — the virtual taps and the SAE visualizer.

One set of numpy ResNet-18 weights (``convert.py``) and one JAX-initialised
dictionary go to both packages; the same 32×32 images go through both on
the CPU. Codes of the ``"layer2.sae"`` / ``"layer2.tc"`` taps agree within
1e-4 of their largest value (float32 convolutions summed in another order,
then an exact top-k on values that agree to that level); names, cache
directories, collected ids and bf16 values (within one bf16 step, 2^-7
relative) are equal, and caches written by either package load in the other.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semanticlens_tpu import sae as jsae
from semanticlens_tpu.collect import SAEComponentVisualizer as JSAECV
from semanticlens_tpu.data import ArrayDataset as JDS
from semanticlens_tpu.models.resnet import ResNet as JResNet
from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch import sae as tsae
from semanticlens_tpu_torch.collect import SAEComponentVisualizer as TSAECV
from semanticlens_tpu_torch.data import ArrayDataset as TDS
from semanticlens_tpu_torch.models.resnet import ResNet as TResNet

torch.set_num_threads(2)

LAYER, N_LAT, K = "layer2", 64, 4
IMAGES = np.random.default_rng(0).random((24, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(JAX ResNet-18, port ResNet-18), the same weights, both named ``r18``."""
    tmodel = TResNet(depth=18, num_classes=10, dtype=torch.float32, device="cpu")
    npp = tmodel.init_jax_layout(0)
    tmodel.params, tmodel.name = tmodel.load_jax_params(npp), "r18"
    jmodel = JResNet(depth=18, num_classes=10, dtype=jnp.float32)
    jmodel.params, jmodel.name = {k: jnp.asarray(v) for k, v in npp.items()}, "r18"
    return jmodel, tmodel


@pytest.fixture(scope="module")
def dictionaries():
    """A TopK SAE and a 128 → 128 skip transcoder (its codes tap reads only the input side),
    JAX-initialised with non-zero biases, ``k`` stamped in: ``{kind: (jax params, port params)}``."""
    out = {}
    for kind, kw in (("sae", {"d_in": 128, "n_latents": N_LAT, "k": K}),
                     ("tc", {"d_in": 128, "n_latents": N_LAT, "k": K, "d_out": 128, "skip": True})):
        cfg = jsae.SAEConfig(**kw)
        rng = np.random.default_rng(len(kind))
        p = {n: np.asarray(v) + rng.normal(scale=0.05, size=v.shape).astype(np.float32)
             for n, v in jsae.init_sae(jax.random.PRNGKey(1), cfg).items()}
        jp = jsae.finalize_sae_params({n: jnp.asarray(v) for n, v in p.items()}, cfg)
        out[kind] = (jp, convert.sae_params_from_jax({n: np.asarray(v) for n, v in jp.items()}, device="cpu"))
    return out


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, f"{what}: max |Δ| {err:.3g} > {rel} × {scale:.3g}"


def test_sae_tap_and_name_equal_jax(pair, dictionaries):
    jmodel, tmodel = pair
    jp, tp = dictionaries["sae"]
    jsub = jsae.SAESubjectModel(jmodel, LAYER, jp)
    tsub = tsae.SAESubjectModel(tmodel, LAYER, tp)
    assert tsub.name == jsub.name and tsub.name.startswith(f"r18-sae_{LAYER}_{N_LAT}k{K}_")
    assert tsub.sae_tap == jsub.sae_tap == "layer2.sae" and tsub.module_names == tuple(jsub.module_names)
    assert tsub.k == K and tsub.device == tmodel.device
    _, jt = jax.jit(lambda p, x: jsub.apply(p, x, (LAYER, "layer2.sae")))(jsub.params, jnp.asarray(IMAGES[:6]))
    with torch.inference_mode():
        _, tt = tsub.apply(tsub.params, torch.from_numpy(IMAGES[:6]), (LAYER, "layer2.sae"))
    assert tt["layer2.sae"].shape == (6, 4, 4, N_LAT) and tt["layer2.sae"].dtype == torch.float32
    _close(tt["layer2.sae"].numpy(), jt["layer2.sae"], 1e-4, "codes")
    _close(tt[LAYER].numpy(), jt[LAYER], 1e-4, "base tap")
    assert int((tt["layer2.sae"] > 0).sum(-1).max()) <= K
    _, only = tsub.apply(tsub.params, torch.from_numpy(IMAGES[:2]), ("layer2.sae",))
    assert set(only) == {"layer2.sae"}  # the layer tap it needed is not leaked


def test_transcoder_tap_and_name_equal_jax(pair, dictionaries):
    jmodel, tmodel = pair
    jp, tp = dictionaries["tc"]
    jsub = jsae.TranscoderSubjectModel(jmodel, LAYER, "layer3.0.conv1", jp)
    tsub = tsae.TranscoderSubjectModel(tmodel, LAYER, "layer3.0.conv1", tp)
    assert tsub.name == jsub.name and tsub.tc_tap == "layer2.tc"
    _, jt = jax.jit(lambda p, x: jsub.apply(p, x, ("layer2.tc",)))(jsub.params, jnp.asarray(IMAGES[:6]))
    _, tt = tsub.apply(tsub.params, torch.from_numpy(IMAGES[:6]), ("layer2.tc",))
    assert set(tt) == {"layer2.tc"}
    _close(tt["layer2.tc"].numpy(), jt["layer2.tc"], 1e-4, "transcoder codes")


def test_constructor_errors_match_jax(pair, dictionaries):
    jmodel, tmodel = pair
    (jp, tp), (jtc, ttc) = dictionaries["sae"], dictionaries["tc"]
    cases = [  # (arguments for the JAX and the port class, what the error says)
        ("sae", ("nope",), {}, "not found"),
        ("sae", (LAYER,), {"k": K + 1}, "contradicts"),
        ("sae-bare", (LAYER,), {}, "sparsity unknown"),
        ("tc", (LAYER, LAYER), {}, "tap_in == tap_out"),
        ("tc-plain", (LAYER, "layer3"), {}, "plain SAE dictionary"),
        ("tc", (LAYER, "nope"), {}, "not found"),
        ("tc", (LAYER, "layer3"), {"k": K + 1}, "contradicts"),
    ]
    for kind, taps, kw, match in cases:
        j_dict, t_dict = {"sae": (jp, tp), "sae-bare": (jp, tp), "tc": (jtc, ttc), "tc-plain": (jp, tp)}[kind]
        if kind == "sae-bare":
            j_dict, t_dict = ({n: v for n, v in d.items() if n != "k"} for d in (j_dict, t_dict))
        j_cls, t_cls = ((jsae.SAESubjectModel, tsae.SAESubjectModel) if kind.startswith("sae")
                        else (jsae.TranscoderSubjectModel, tsae.TranscoderSubjectModel))
        with pytest.raises(ValueError, match=match):
            j_cls(jmodel, *taps, j_dict, **kw)
        with pytest.raises(ValueError, match=match):
            t_cls(tmodel, *taps, t_dict, **kw)
    assert tsae.SAESubjectModel(tmodel, LAYER, {n: v for n, v in tp.items() if n != "k"}, k=K).k == K
    # replace=True builds the patch path (held against JAX in test_transcoder_replace_patch_matches_jax)
    assert tsae.TranscoderSubjectModel(tmodel, LAYER, "layer3", ttc, replace=True).replace
    assert jsae.TranscoderSubjectModel(jmodel, LAYER, "layer3", jtc, replace=True).replace


def test_transcoder_replace_patch_matches_jax(pair, dictionaries):
    """``replace=True``: the skip transcoder's prediction from ``layer2.0`` substitutes ``layer2.1``."""
    jmodel, tmodel = pair
    jp, tp = dictionaries["tc"]
    jsub = jsae.TranscoderSubjectModel(jmodel, "layer2.0", "layer2.1", jp, replace=True)
    tsub = tsae.TranscoderSubjectModel(tmodel, "layer2.0", "layer2.1", tp, replace=True)
    jout, jt = jsub.apply(jsub.params, jnp.asarray(IMAGES[:6]), ("layer2.1", "layer2.0.tc"))
    tout, tt = tsub.apply(tsub.params, torch.from_numpy(IMAGES[:6]), ("layer2.1", "layer2.0.tc"))
    _close(tout.numpy(), jout, 1e-4, "patched logits")
    _close(tt["layer2.1"].numpy(), jt["layer2.1"], 1e-4, "substituted tap")
    _close(tt["layer2.0.tc"].numpy(), jt["layer2.0.tc"], 1e-4, "codes")
    clean, _ = tmodel.apply(tmodel.params, torch.from_numpy(IMAGES[:6]))
    assert float((tout - clean).abs().max()) > 0


def test_dictionary_moves_to_the_base_models_device(pair, dictionaries):
    _, tmodel = pair
    jp, _ = dictionaries["sae"]
    sub = tsae.SAESubjectModel(tmodel, LAYER, {n: np.asarray(v) for n, v in jp.items()})
    assert all(v.device.type == "cpu" and v.dtype == torch.float32 for n, v in sub.params["sae"].items() if n != "k")
    assert sub.params["sae"]["k"] == K


# --------------------------------------------------------------- visualizer
class FakeVLM:
    """Mean pixel projected to 7 dims, on the CPU."""

    name = "fake-vlm"
    device = torch.device("cpu")

    def preprocess(self, img):
        return torch.as_tensor(img).float()

    def encode_image(self, img):
        proj = torch.from_numpy(np.random.default_rng(99).normal(size=(3, 7)).astype(np.float32))
        return img.mean(dim=(1, 2)) @ proj


def _cvs(pair, dictionaries, cache_dir=None):
    jmodel, tmodel = pair
    jp, tp = dictionaries["sae"]
    kw = {"num_samples": 5, "cache_dir": None if cache_dir is None else str(cache_dir)}
    jcv = JSAECV(jmodel, JDS(IMAGES, name="imgs"), JDS(IMAGES, name="imgs"), LAYER, jp, **kw)
    tds = TDS(IMAGES, name="imgs")
    tcv = TSAECV(tmodel, tds, tds, LAYER, tp, **kw)
    return jcv, tcv


def test_visualizer_ids_and_values_equal_jax(pair, dictionaries):
    jcv, tcv = _cvs(pair, dictionaries)
    assert tcv.layer_names == jcv.layer_names == ["layer2.sae"]
    jc, tc = jcv.run(batch_size=8)["layer2.sae"], tcv.run(batch_size=8)["layer2.sae"]
    assert tc.activations.shape == (N_LAT, 5)
    np.testing.assert_array_equal(tc.sample_ids, np.asarray(jc.sample_ids))
    np.testing.assert_allclose(tc.activations.float().numpy(), np.asarray(jc.activations, np.float32),
                               rtol=2**-7, atol=1e-6)
    vals = tc.activations.float().numpy()
    assert (np.diff(vals, axis=1) <= 0).all() and (vals >= 0).all()


def test_visualizer_matches_brute_force_codes(pair, dictionaries):
    """The streamed top-k over the virtual tap equals encoding every position and taking each image's max."""
    _, tmodel = pair
    _, tp = dictionaries["sae"]
    _, tcv = _cvs(pair, dictionaries)
    got = tcv.run(batch_size=8)["layer2.sae"].activations.float().numpy()
    with torch.inference_mode():
        _, taps = tmodel.apply(tmodel.params, torch.from_numpy(IMAGES), (LAYER,))
        per_image = tsae.encode(tp, taps[LAYER], k=K).amax(dim=(1, 2)).T.to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, np.maximum(-np.sort(-per_image, axis=1)[:, :5], 0.0))


def test_concept_db_sentinels_are_zero_rows(pair, dictionaries):
    _, tcv = _cvs(pair, dictionaries)
    db = tcv._compute_concept_db(FakeVLM(), batch_size=8)["layer2.sae"]
    ids = tcv.get_max_reference("layer2.sae")
    assert db.shape == (N_LAT, 5, 7) and ids.shape == (N_LAT, 5)
    assert (db[ids < 0] == 0).all() and np.abs(db[ids >= 0]).sum() > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_caches_load_across_packages(pair, dictionaries, tmp_path, writer):
    jcv, tcv = _cvs(pair, dictionaries, tmp_path)
    assert tcv.storage_dir == jcv.storage_dir
    assert tcv.storage_dir.parts[-3:] == ("SAEComponentVisualizer", "imgs", jcv.model.name)
    first = (jcv if writer == "jax" else tcv).run(batch_size=8)["layer2.sae"]
    jcv2, tcv2 = _cvs(pair, dictionaries, tmp_path)
    reader = tcv2 if writer == "jax" else jcv2
    reader.engine = None  # a recompute would fail: the cache must load
    loaded = reader.run(batch_size=8)["layer2.sae"]
    np.testing.assert_array_equal(np.asarray(loaded.sample_ids), np.asarray(first.sample_ids))
    np.testing.assert_array_equal(np.asarray(loaded.activations, np.float32) if writer == "port"
                                  else loaded.activations.float().numpy(),
                                  np.asarray(first.activations, np.float32) if writer == "jax"
                                  else first.activations.float().numpy())


def test_cache_identity_follows_the_dictionary(pair, dictionaries, tmp_path):
    _, tmodel = pair
    _, tp = dictionaries["sae"]
    other = {**tp, "W_dec": tp["W_dec"] + 1e-3}
    tds = TDS(IMAGES, name="imgs")
    a = TSAECV(tmodel, tds, tds, LAYER, tp, 5, cache_dir=str(tmp_path))
    b = TSAECV(tmodel, tds, tds, LAYER, other, 5, cache_dir=str(tmp_path))
    assert a.storage_dir != b.storage_dir


def test_train_static_method_and_refusals(pair, dictionaries):
    _, tmodel = pair
    _, tp = dictionaries["sae"]
    tds = TDS(IMAGES, name="imgs")
    cfg = tsae.SAEConfig(d_in=128, n_latents=N_LAT, k=K, lr=2e-3, batch_rows=32, positions_per_image=8)
    trained = TSAECV.train(tmodel, tds, LAYER, cfg, batch_size=8, epochs=2)
    assert trained["W_dec"].shape == (N_LAT, 128) and trained["k"] == K
    cache = TSAECV(tmodel, tds, tds, LAYER, trained, 5).run(batch_size=8)
    assert np.isfinite(cache["layer2.sae"].activations.float().numpy()).all()
    with pytest.raises(TypeError, match="DeviceMesh"):
        TSAECV(tmodel, tds, tds, LAYER, tp, 5, mesh=object())
    bare = TResNet(depth=18, num_classes=10, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="weights required"):
        TSAECV(bare, tds, tds, LAYER, tp, 5)
    with pytest.raises(ValueError, match="weights required"):
        TSAECV.train(bare, tds, LAYER, cfg)
