"""The port's first slice end to end against the JAX package, at tiny size.

Collect → Embed → Analyze through the user-facing entry points of both
packages (README quickstart steps 1–4) on the CPU in float32: a ResNet-18
subject tapping layer3/layer4, a cut-down CLIP ViT tower with the hash
tokenizer, one raw uint8 dataset feeding the fused single pass. Both
packages get the same numpy weights (the port through ``convert.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu.collect import ActivationComponentVisualizer as JCV
from semanticlens_tpu.data import ArrayDataset as JDataset
from semanticlens_tpu.foundation_models import clip as jclip
from semanticlens_tpu.foundation_models.tokenizer import HashTokenizer as JHash
from semanticlens_tpu.lens import Lens as JLens
from semanticlens_tpu.models.resnet import ResNet as JResNet
from semanticlens_tpu.ops.aggregators import aggregate_conv_mean as j_mean
from semanticlens_tpu.utils import make_preprocess_fn as j_pre
from semanticlens_tpu_torch import Lens as TLens
from semanticlens_tpu_torch.collect import ActivationComponentVisualizer as TCV
from semanticlens_tpu_torch.data import ArrayDataset as TDataset
from semanticlens_tpu_torch.foundation_models import clip as tclip
from semanticlens_tpu_torch.models import ResNet as TResNet
from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean as t_mean
from semanticlens_tpu_torch.utils import make_preprocess_fn as t_pre

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
LAYERS = ["layer3", "layer4"]
N_IMAGES, NUM_SAMPLES, BATCH = 14, 4, 4  # a padded last batch
QUERIES, TEMPLATES = ["dog", "red car"], ["a photo of a {}", "{} in the wild"]


def _build(pkg, tmp_path, images, np_resnet, np_clip):
    """One package's quickstart objects, both with a cache directory."""
    if pkg == "jax":
        model = JResNet(depth=18, dtype=jnp.float32)
        model.params = {k: jnp.asarray(v) for k, v in np_resnet.items()}
        fm = jclip.OpenClip("ViT-B-32", params={k: jnp.asarray(v) for k, v in np_clip.items()},
                            dtype=jnp.float32)
        fm.cfg, fm.tokenizer = TINY_J, JHash(50, 12)
        dataset, cv_cls, lens_cls, agg, pre = JDataset(images, name="toy"), JCV, JLens, j_mean, j_pre
    else:
        model = TResNet(depth=18, dtype=torch.float32, device="cpu")
        model.params = model.load_jax_params(np_resnet)
        fm = tclip.OpenClip("ViT-B-32", jax_params=np_clip, dtype=torch.float32, device="cpu",
                            cfg=TINY_T)
        dataset, cv_cls, lens_cls, agg, pre = TDataset(images, name="toy"), TCV, TLens, t_mean, t_pre
    model.name = "resnet18-toy"
    cv = cv_cls(model=model, dataset_model=dataset, dataset_fm=dataset, layer_names=LAYERS,
                num_samples=NUM_SAMPLES, aggregate_fn=agg, model_preprocess=pre(size=32),
                cache_dir=str(tmp_path / pkg))
    return cv, lens_cls(fm)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("slice")
    images = np.random.default_rng(0).integers(0, 256, size=(N_IMAGES, 40, 48, 3), dtype=np.uint8)
    np_resnet = TResNet(depth=18, device="cpu").init_jax_layout(seed=0)
    np_clip = tclip.init_clip_params_jax_layout(1, TINY_T)
    out = {}
    for pkg in ("jax", "torch"):
        cv, lens = _build(pkg, tmp_path, images, np_resnet, np_clip)
        db = {k: np.asarray(v) for k, v in lens.compute_concept_db(cv, batch_size=BATCH).items()}
        agg = {k: v.mean(1) for k, v in db.items()}
        out[pkg] = {
            "cv": cv, "lens": lens, "db": db,
            "ids": {k: np.asarray(cv.get_max_reference(k)) for k in LAYERS},
            "values": {k: np.asarray(cv.actmax_cache[k].activations, np.float32) if pkg == "jax"
                       else cv.actmax_cache[k].activations.float().numpy() for k in LAYERS},
            "table": np.asarray(cv.embedding_table),
            "probe": lens.text_probing(QUERIES, agg, templates=TEMPLATES),
            "probe_plain": lens.text_probing("dog", agg),
            "probe_image": lens.image_probing(images[:3], agg),
            "clarity": {k: np.asarray(v) for k, v in lens.eval_clarity(db).items()},
            "redundancy": {k: np.asarray(v) for k, v in lens.eval_redundancy(agg).items()},
        }
    return out


def test_actmax_ids_and_values_match(both):
    for layer in LAYERS:
        np.testing.assert_array_equal(both["torch"]["ids"][layer], both["jax"]["ids"][layer])
        np.testing.assert_allclose(both["torch"]["values"][layer], both["jax"]["values"][layer],
                                   rtol=2**-7)  # bf16 storage: at most one rounding step (2^-7 relative) apart


def test_embedding_table_and_concept_db_match(both):
    """float32 tiny tower: atol 2e-4 (the towers' parity tolerance)."""
    np.testing.assert_allclose(both["torch"]["table"], both["jax"]["table"], atol=2e-4)
    for layer in LAYERS:
        t, j = both["torch"]["db"][layer], both["jax"]["db"][layer]
        assert t.shape == j.shape == (256 if layer == "layer3" else 512, NUM_SAMPLES, 16)
        np.testing.assert_allclose(t, j, atol=2e-4)


def test_probe_and_scores_match(both):
    for key in ("probe", "probe_plain", "probe_image"):
        for layer in LAYERS:
            np.testing.assert_allclose(both["torch"][key][layer], both["jax"][key][layer], atol=1e-4)
    for key in ("clarity", "redundancy"):
        for layer in LAYERS:
            np.testing.assert_allclose(both["torch"][key][layer], both["jax"][key][layer], atol=1e-4)


def test_caches_cross_load_between_packages(both):
    """Each package's on-disk ActMax cache restores the other's state."""
    from semanticlens_tpu.collect.activation_caching import ActMaxCache as JCache
    from semanticlens_tpu_torch.collect.activation_caching import ActMaxCache as TCache

    jcv, tcv = both["jax"]["cv"], both["torch"]["cv"]
    assert jcv.storage_dir.relative_to(jcv._cache_root) == tcv.storage_dir.relative_to(tcv._cache_root)
    from_torch = JCache(LAYERS, j_mean, NUM_SAMPLES)
    from_torch.load(tcv.storage_dir)
    from_jax = TCache(LAYERS, t_mean, NUM_SAMPLES, device="cpu")
    from_jax.load(jcv.storage_dir)
    for layer in LAYERS:
        np.testing.assert_array_equal(np.asarray(from_torch[layer].sample_ids), both["torch"]["ids"][layer])
        np.testing.assert_array_equal(from_jax[layer].sample_ids, both["jax"]["ids"][layer])


def test_concept_db_cache_hit_returns_stored_db(both):
    lens, cv = both["torch"]["lens"], both["torch"]["cv"]
    again = lens.compute_concept_db(cv, batch_size=BATCH)
    for layer in LAYERS:
        np.testing.assert_array_equal(again[layer], both["torch"]["db"][layer])


def test_polysemanticity_runs_on_slice_output(both):
    poly = both["torch"]["lens"].eval_polysemanticity(both["torch"]["db"])
    for layer in LAYERS:
        v = poly[layer].numpy()
        assert v.shape == (both["torch"]["db"][layer].shape[0],) and np.isfinite(v).all()


def test_engine_rejects_ids_beyond_int32():
    """Sample ids are int32 on the device, as in the JAX engine; the sweep refuses to wrap."""
    from semanticlens_tpu.collect.engine import CollectEngine as JEngine
    from semanticlens_tpu_torch.collect.engine import CollectEngine as TEngine

    limit = np.iinfo(np.int32).max
    for check in (JEngine._check_id_range, TEngine._check_id_range):
        check(10, limit - 10)
        with pytest.raises(ValueError, match="int32"):
            check(10, limit - 9)
