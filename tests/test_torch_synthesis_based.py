"""``SynthesisComponentVisualizer`` against the JAX package's, on the same weights and draws.

The cases of JAX ``tests/collect/test_synthesis_based.py`` that apply to
one device (synthesis split over ranks is held in
``test_torch_mesh_train.py``). The two-conv model of
``test_torch_featviz.py`` carries the same weights in both packages, and the
port's draws are the JAX keys' (computed per chunk seed, which the CPU
generator carries as its ``initial_seed``), so galleries agree within 1e-5
and concept DBs through one fake foundation model within 1e-5. The gallery
digest, file name and file are the JAX package's: a gallery either package
writes loads in the other without re-optimizing.
"""

import logging
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu.collect.synthesis_based import SynthesisComponentVisualizer as JSCV
from semanticlens_tpu.featviz import SynthesisConfig as JConfig
from semanticlens_tpu.ops.aggregators import aggregate_conv_max as j_max
from semanticlens_tpu.ops.aggregators import aggregate_conv_mean as j_mean
from semanticlens_tpu_torch import Lens, scores
from semanticlens_tpu_torch import featviz as tfv
from semanticlens_tpu_torch.collect import SynthesisComponentVisualizer as TSCV
from semanticlens_tpu_torch.featviz import SynthesisConfig as TConfig
from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_max as t_max
from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean as t_mean
from test_torch_featviz import IMG, _preprocess, jax_stream, tiny_pair

torch.set_num_threads(2)

FAST = dict(steps=12, lr=0.1, jitter=2, tv=0.0, l2=1e-4)
PROJ = np.random.default_rng(5).normal(size=(3, 12)).astype(np.float32)


class JFakeVLM:
    name = "fake-vlm"
    embed_dim = 12

    def preprocess(self, img):
        arr = np.asarray(img, np.float32)
        return jnp.asarray(arr[None] if arr.ndim == 3 else arr)

    def encode_image(self, img):
        return jnp.mean(img, axis=(1, 2)) @ jnp.asarray(PROJ)


class TFakeVLM:
    """The same fake embedding in torch, on the CPU."""

    name = "fake-vlm"
    embed_dim = 12
    device = torch.device("cpu")

    def preprocess(self, img):
        img = torch.as_tensor(img).to(torch.float32)
        return img[None] if img.ndim == 3 else img

    def encode_image(self, img):
        return torch.mean(img, dim=(1, 2)) @ torch.from_numpy(PROJ)


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's canvas init and draws become the JAX keys' for the seed each call runs with."""
    def init(cfg, k, canvas_hw, generator):
        return torch.from_numpy(jax_stream(cfg, k, canvas_hw - 2 * cfg.jitter, generator.initial_seed())[0].copy())

    def draws(cfg, k, generator):
        _, offsets, flips = jax_stream(cfg, k, 1, generator.initial_seed())  # the draws ignore the canvas size
        return offsets, flips

    monkeypatch.setattr(tfv, "_init_canvas", init)
    monkeypatch.setattr(tfv, "_draws", draws)


@pytest.fixture(scope="module")
def models():
    return tiny_pair()


def _make(pkg, models, tmp_path=None, **kw):
    jmodel, tmodel = models
    cls, model, cfg, agg = ((JSCV, jmodel, JConfig, j_mean) if pkg == "jax" else (TSCV, tmodel, TConfig, t_mean))
    args = dict(layer_names=["0"], n_components={"0": 4}, num_samples=2, aggregate_fn=agg, image_size=IMG,
                model_preprocess=_preprocess, config=cfg(**FAST), max_batch=3,
                cache_dir=str(tmp_path / pkg) if tmp_path else None) | kw
    return cls(model, args.pop("layer_names"), args.pop("n_components"), args.pop("num_samples"),
               args.pop("aggregate_fn"), **args)


def test_gallery_objectives_and_concept_db_match_jax(models, jax_draws):
    """4 components × 2 variants at max_batch 3: chunks at seeds 0, 3, 6, the last padded with repeats."""
    jcv, tcv = _make("jax", models), _make("torch", models)
    jg, tg = jcv.run(), tcv.run()
    assert tg["0"].shape == (4, 2, IMG, IMG, 3) and tg["0"].dtype == np.float32
    np.testing.assert_allclose(tg["0"], jg["0"], atol=1e-5)
    np.testing.assert_allclose(tcv.objectives["0"], jcv.objectives["0"], atol=1e-5)
    jdb = jcv._compute_concept_db(JFakeVLM(), batch_size=3)
    tdb = tcv._compute_concept_db(TFakeVLM(), batch_size=3)
    assert tdb["0"].shape == (4, 2, 12)
    np.testing.assert_allclose(tdb["0"], jdb["0"], atol=1e-5)
    flat = torch.from_numpy((tg["0"].reshape(8, IMG, IMG, 3) * 255.0).astype(np.uint8))
    direct = TFakeVLM().encode_image(TFakeVLM().preprocess(flat)).numpy().reshape(4, 2, -1)
    np.testing.assert_allclose(tdb["0"], direct, atol=1e-5)
    np.testing.assert_array_equal(tcv.get_max_reference("0"), jcv.get_max_reference("0"))
    np.testing.assert_array_equal(tcv.get_images("0", 2), tg["0"][2])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_gallery_either_package_writes_loads_in_the_other(models, tmp_path, writer, jax_draws, monkeypatch):
    reader = "torch" if writer == "jax" else "jax"
    wcv = _make(writer, models, tmp_path)
    wcv.run()
    rcv = _make(reader, models, tmp_path)
    assert rcv.metadata == wcv.metadata and rcv._config_digest() == wcv._config_digest()
    path = rcv._gallery_path("0")
    shutil.copytree(tmp_path / writer, tmp_path / reader, dirs_exist_ok=True)
    assert path.exists() and path.name == wcv._gallery_path("0").name

    def never(*a, **k):
        raise AssertionError("re-optimized instead of loading the gallery")

    monkeypatch.setattr(tfv, "synthesize", never)
    monkeypatch.setattr("semanticlens_tpu_torch.collect.synthesis_based.synthesize", never)
    monkeypatch.setattr("semanticlens_tpu.collect.synthesis_based.synthesize", never)
    rcv.run()
    own = _make(writer, models, tmp_path)  # the writer's own reload: the uint8 round trip
    own.run()
    np.testing.assert_array_equal(rcv.gallery["0"], own.gallery["0"])
    np.testing.assert_array_equal(rcv.objectives["0"], own.objectives["0"])


def test_cache_roundtrip_and_lens(models, tmp_path):
    cv1 = _make("torch", models, tmp_path)
    lens = Lens(TFakeVLM())
    db = lens.compute_concept_db(cv1, batch_size=4)
    assert set(db) == {"0"} and db["0"].shape == (4, 2, 12)
    cv2 = _make("torch", models, tmp_path)
    cv2.run()
    np.testing.assert_allclose(cv2.gallery["0"], cv1.gallery["0"], atol=1 / 255.0)  # uint8 storage
    np.testing.assert_array_equal(cv2.objectives["0"], cv1.objectives["0"])
    np.testing.assert_allclose(lens.compute_concept_db(cv2, batch_size=4)["0"], db["0"], atol=1e-6)  # DB cache
    clarity = scores.clarity_score(db["0"], device="cpu").numpy()
    assert clarity.shape == (4,) and np.isfinite(clarity).all()


@pytest.mark.parametrize("variant", [{}, {"n_components": {"0": 3}}, {"max_batch": 4}, {"aggregate_fn": "max"},
                                     {"config": {"lr": 0.05}}, {"seed": 1}, {"image_size": 8}],
                         ids=["base", "components", "max_batch", "aggregator", "config", "seed", "image_size"])
def test_digest_and_metadata_equal_jax_and_every_setting_misses(models, tmp_path, variant):
    kw = {}
    for pkg in ("jax", "torch"):
        kw[pkg] = dict(variant)
        if "aggregate_fn" in variant:
            kw[pkg]["aggregate_fn"] = j_max if pkg == "jax" else t_max
        if "config" in variant:
            kw[pkg]["config"] = (JConfig if pkg == "jax" else TConfig)(**(FAST | variant["config"]))
    jcv, tcv = _make("jax", models, tmp_path, **kw["jax"]), _make("torch", models, tmp_path, **kw["torch"])
    assert tcv._config_digest() == jcv._config_digest() and tcv.metadata == jcv.metadata
    assert tcv.storage_dir.relative_to(tmp_path / "torch") == jcv.storage_dir.relative_to(tmp_path / "jax")
    base = _make("torch", models, tmp_path)
    assert (tcv._gallery_path("0") == base._gallery_path("0")) == (not variant)


def test_wrong_shaped_cached_gallery_triggers_resynthesis(models, tmp_path, caplog):
    cv1 = _make("torch", models, tmp_path)
    cv1.run()
    cv2 = _make("torch", models, tmp_path, n_components={"0": 3})
    path2 = cv2._gallery_path("0")
    shutil.copy(cv1._gallery_path("0"), path2)  # wrong shape (4 vs 3 components)
    with caplog.at_level(logging.WARNING):
        cv2.run()
    assert cv2.gallery["0"].shape == (3, 2, IMG, IMG, 3)
    assert any("re-synthesizing" in r.message for r in caplog.records)


def test_visualize_components(models, tmp_path):
    cv = _make("torch", models, tmp_path)
    fpath = cv.visualize_components([0, 1], layer_name="0")
    assert fpath is not None and fpath.exists() and fpath.stat().st_size > 200
    assert fpath.name == "0_0-1.png" and fpath.parent == cv.storage_dir / "plots"
    assert _make("torch", models).visualize_components([0], layer_name="0") is None  # caching off
    with pytest.raises(ValueError, match="not found"):
        cv.visualize_components([0], layer_name="nope")


@pytest.mark.parametrize("kwargs,match", [({"layer_names": ["nope"]}, "not found"),
                                          ({"layer_names": ["0", "1"]}, "missing entries")],
                         ids=["unknown-layer", "component-counts"])
def test_constructor_errors(models, kwargs, match):
    with pytest.raises(ValueError, match=match):
        _make("torch", models, **kwargs)
    with pytest.raises(ValueError, match=match):
        _make("jax", models, **kwargs)
