"""BASELINE config 3 at tiny size: ViT subject → MLP neurons and attention heads → SigLIP → text probing.

Both packages, the user-facing entry points, float32 on the CPU: a cut-down
subject ViT (32×32 images, 8×8 patches, width 32, 2 blocks, 2 heads) tapped
at ``blocks.1.mlp.fc1`` (128 neurons) and ``blocks.1.attn.heads`` (2 heads)
with ``aggregate_transformer_mean``; the fused Collect+Embed pass into a
cut-down ``SigLipV2`` (width 64, hash tokenizer); then the concept DB, text
probing, labels, clarity and redundancy. One set of numpy weights per model
goes to both packages (the port through ``convert``). Top-k ids must be
equal; the concept DB and the embedding table within atol 2e-5 (SigLIP
embeddings of norm ≈ 7–9), probe scores, labels' scores, clarity and
redundancy within atol 1e-5. Each package's concept-DB cache file (keyed on
``SigLipV2(hf-hub:timm/ViT-B-16-SigLIP2)``) loads in the other without a
recompute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu.collect import ActivationComponentVisualizer as JCV
from semanticlens_tpu.data import ArrayDataset as JDataset
from semanticlens_tpu.foundation_models import siglip as jsig
from semanticlens_tpu.foundation_models.tokenizer import HashTokenizer as JHash
from semanticlens_tpu.lens import Lens as JLens
from semanticlens_tpu.models.vit import VisionTransformer as JViT
from semanticlens_tpu.ops.aggregators import aggregate_transformer_mean as j_mean
from semanticlens_tpu.utils import make_preprocess_fn as j_pre
from semanticlens_tpu_torch import Lens as TLens
from semanticlens_tpu_torch.collect import ActivationComponentVisualizer as TCV
from semanticlens_tpu_torch.data import ArrayDataset as TDataset
from semanticlens_tpu_torch.foundation_models import siglip as tsig
from semanticlens_tpu_torch.models import VisionTransformer as TViT
from semanticlens_tpu_torch.ops.aggregators import aggregate_transformer_mean as t_mean
from semanticlens_tpu_torch.utils import make_preprocess_fn as t_pre

torch.set_num_threads(2)

VIT = dict(image_size=32, patch_size=8, width=32, depth=2, heads=2, num_classes=4)
SIGLIP = dict(embed_dim=64, image_size=32, patch_size=8, vision_width=64, vision_layers=2, vision_heads=4,
              text_width=64, text_layers=2, text_heads=4, vocab_size=1000, context_length=16)
LAYERS = ["blocks.1.mlp.fc1", "blocks.1.attn.heads"]
N_IMAGES, NUM_SAMPLES, BATCH = 14, 4, 4  # a padded last batch
QUERIES, TEMPLATES = ["dog", "red car", "tree"], ["a photo of a {}"]
VOCAB = [f"word {i}" for i in range(20)]


def _build(pkg, tmp_path, np_vit, np_siglip):
    if pkg == "jax":
        model = JViT(**VIT, dtype=jnp.float32)
        model.params = {k: jnp.asarray(v) for k, v in np_vit.items()}
        fm = jsig.SigLipV2(params={k: jnp.asarray(v) for k, v in np_siglip.items()}, dtype=jnp.float32)
        fm.cfg, fm.tokenizer = jsig.SigLIPConfig(**SIGLIP), JHash(1000, 16)
        dataset, cv_cls, lens_cls, agg, pre = JDataset, JCV, JLens, j_mean, j_pre
    else:
        model = TViT(**VIT, dtype=torch.float32, device="cpu")
        model.params = model.load_jax_params(np_vit)
        fm = tsig.SigLipV2(jax_params=np_siglip, dtype=torch.float32, device="cpu", cfg=tsig.SigLIPConfig(**SIGLIP))
        dataset, cv_cls, lens_cls, agg, pre = TDataset, TCV, TLens, t_mean, t_pre
    model.name = "vit-b16-toy"
    return model, fm, dataset, cv_cls, lens_cls, agg, pre


def _visualizer(pkg, cache_dir, images, model, dataset_cls, cv_cls, agg, pre):
    dataset = dataset_cls(images, name="toy")
    return cv_cls(model=model, dataset_model=dataset, dataset_fm=dataset, layer_names=LAYERS, num_samples=NUM_SAMPLES,
                  aggregate_fn=agg, model_preprocess=pre(size=32), cache_dir=str(cache_dir))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("config3")
    images = np.random.default_rng(0).integers(0, 256, size=(N_IMAGES, 40, 48, 3), dtype=np.uint8)
    np_vit = TViT(**VIT, device="cpu").init_jax_layout(seed=0)
    np_siglip = tsig.init_siglip_params_jax_layout(1, tsig.SigLIPConfig(**SIGLIP))
    out = {"images": images, "tmp": tmp_path, "np": (np_vit, np_siglip)}
    for pkg in ("jax", "torch"):
        model, fm, dataset_cls, cv_cls, lens_cls, agg, pre = _build(pkg, tmp_path, np_vit, np_siglip)
        cv = _visualizer(pkg, tmp_path / pkg, images, model, dataset_cls, cv_cls, agg, pre)
        lens = lens_cls(fm)
        db = {k: np.asarray(v) for k, v in lens.compute_concept_db(cv, batch_size=BATCH).items()}
        agg_db = {k: v.mean(1) for k, v in db.items()}
        labels = lens.label_components(VOCAB, agg_db, top_m=3)
        out[pkg] = {
            "cv": cv, "lens": lens, "db": db, "fm": fm,
            "ids": {k: np.asarray(cv.get_max_reference(k)) for k in LAYERS},
            "table": np.asarray(cv.embedding_table),
            "probe": lens.text_probing(QUERIES, agg_db, templates=TEMPLATES),
            "labels": {k: (v[0], np.asarray(v[1])) for k, v in labels.items()},
            "clarity": {k: np.asarray(v) for k, v in lens.eval_clarity(db).items()},
            "redundancy": {k: np.asarray(v) for k, v in lens.eval_redundancy(agg_db).items()},
        }
    return out


def test_ids_equal_and_shapes(both):
    for layer, components in zip(LAYERS, (128, 2)):
        np.testing.assert_array_equal(both["torch"]["ids"][layer], both["jax"]["ids"][layer])
        assert both["torch"]["db"][layer].shape == both["jax"]["db"][layer].shape == (components, NUM_SAMPLES, 64)


def test_embedding_table_and_concept_db_match(both):
    np.testing.assert_allclose(both["torch"]["table"], both["jax"]["table"], atol=2e-5)
    for layer in LAYERS:
        np.testing.assert_allclose(both["torch"]["db"][layer], both["jax"]["db"][layer], atol=2e-5)


def test_probe_labels_and_scores_match(both):
    for layer in LAYERS:
        np.testing.assert_allclose(both["torch"]["probe"][layer], both["jax"]["probe"][layer], atol=1e-5)
        t_words, t_scores = both["torch"]["labels"][layer]
        j_words, j_scores = both["jax"]["labels"][layer]
        np.testing.assert_allclose(t_scores, j_scores, atol=1e-5)
        assert [w[0] for w in t_words] == [w[0] for w in j_words]
        for key in ("clarity", "redundancy"):
            np.testing.assert_allclose(both["torch"][key][layer], both["jax"][key][layer], atol=1e-5)


def test_concept_db_caches_cross_load(both):
    """The port reads the JAX package's concept-DB file and the JAX package reads the port's: the visualizer
    built on the other package's cache directory returns the stored DB while encoding would raise."""
    assert both["torch"]["fm"].name == both["jax"]["fm"].name == "SigLipV2(hf-hub:timm/ViT-B-16-SigLIP2)"
    np_vit, np_siglip = both["np"]
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        model, fm, dataset_cls, cv_cls, lens_cls, agg, pre = _build(reader, both["tmp"], np_vit, np_siglip)

        def refuse(*_args, **_kwargs):
            raise AssertionError("the concept DB was recomputed instead of read from the cache")

        fm.encode_image = refuse
        cv = _visualizer(reader, both["tmp"] / writer, both["images"], model, dataset_cls, cv_cls, agg, pre)
        got = lens_cls(fm).compute_concept_db(cv, batch_size=BATCH)
        for layer in LAYERS:
            np.testing.assert_array_equal(np.asarray(got[layer]), both[writer]["db"][layer])
