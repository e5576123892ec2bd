"""``full_audit --cpu --arch X`` for zoo families against the pipeline composed from JAX calls.

The port's own ``build_model`` runs (``--arch`` / ``--variant``: the family's
default layers and model name), then its subject is re-placed in float32
from the same seed; the foundation model is the cut-down CLIP of
``test_torch_full_audit.py`` and the data its 24 labelled 32² images. The
JAX side is the tool's pipeline (``tools/full_audit.py:308-455``) on the
same numpy weights, as ``test_torch_full_audit.py`` composes it: DB shapes,
clarity and redundancy per layer (1e-5 relative), the top neuron per
query, the image probe, the class-selective components and the soft-WPMI
labels are equal; the top-5 per query is equal up to order among
components whose float64 cosines tie within 1e-6 (at 24 images many of
EfficientNet's 1,280 head channels share their 4 evidence images, so
their concept vectors are equal). Two families: ConvNeXt-Tiny (LayerNorm, GELU,
layer scale) and EfficientNet-B0 (BN, SiLU, squeeze-excite).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import semanticlens_tpu.models as J
from semanticlens_tpu import scores as jscores
from semanticlens_tpu.collect import ActivationComponentVisualizer as JCV
from semanticlens_tpu.data import ArrayDataset as JDataset
from semanticlens_tpu.foundation_models import clip as jclip
from semanticlens_tpu.foundation_models.tokenizer import HashTokenizer as JHash
from semanticlens_tpu.lens import Lens as JLens
from semanticlens_tpu.ops.aggregators import aggregate_conv_mean as j_mean
from semanticlens_tpu.utils import make_preprocess_fn as j_pre
from semanticlens_tpu_torch import full_audit
from semanticlens_tpu_torch.data import ArrayDataset as TDataset
from semanticlens_tpu_torch.foundation_models import clip as tclip
from test_torch_full_audit import IMAGES, LABELS, N, TINY_J, TINY_T, VOCAB

torch.set_num_threads(2)

SAMPLES = 4
CASES = [
    (["--arch", "convnext"], "ConvNeXt", dict(variant="tiny"), [f"stages.{i}" for i in range(4)],
     "convnext-tiny-audit"),
    (["--arch", "efficientnet"], "EfficientNet", dict(variant="b0"), [f"features.{i}" for i in (2, 4, 6, 8)],
     "efficientnet-b0-audit"),
]


def _run_port(monkeypatch, argv, np_clip):
    build = full_audit.build_model
    built = {}

    def build_model(args, device):
        model, aggregate_fn = build(args, device)  # the real one: layers, name, bf16 weights from seed 0
        model.dtype, built["model"] = torch.float32, model
        model.params = model.init(seed=0)
        return model, aggregate_fn

    monkeypatch.setattr(full_audit, "build_model", build_model)
    monkeypatch.setattr(full_audit, "build_fm", lambda args, device: tclip.OpenClip(
        "ViT-B-32", jax_params=np_clip, dtype=torch.float32, device=device, cfg=TINY_T))
    monkeypatch.setattr(full_audit, "load_dataset", lambda args, device: TDataset(IMAGES, LABELS, name="toy"))
    report = full_audit.main(["--cpu", "--image-size", "32", "--n-samples", str(SAMPLES), "--batch", "8",
                              "--vocabulary", *VOCAB, "--image-query-indices", "0", "5", "--label-scoring", "wpmi",
                              *argv])
    return report, built["model"]


def _run_jax(model, np_weights, layers, np_clip):
    model.params, model.name = {k: jnp.asarray(v) for k, v in np_weights.items()}, "zoo-audit"
    fm = jclip.OpenClip("ViT-B-32", params={k: jnp.asarray(v) for k, v in np_clip.items()}, dtype=jnp.float32)
    fm.cfg, fm.tokenizer = TINY_J, JHash(50, 12)
    dataset = JDataset(IMAGES, LABELS, name="toy")
    lens = JLens(fm)
    cv = JCV(model=model, dataset_model=dataset, dataset_fm=dataset, layer_names=layers, num_samples=SAMPLES,
             aggregate_fn=j_mean, model_preprocess=j_pre(size=32, crop=32), cache_dir=None)
    db = lens.compute_concept_db(cv, batch_size=8)
    agg = {k: np.asarray(v).mean(1) for k, v in db.items()}
    clarity, redundancy = lens.eval_clarity(db), lens.eval_redundancy(agg)
    queries = ["dog", "car wheel", "striped pattern"]
    q = np.asarray(fm.encode_text(fm.tokenize(queries)), np.float32)
    ids = {k: np.asarray(cv.get_max_reference(k)) for k in layers}
    named = lens.label_components(VOCAB, agg, top_m=1, templates=["a photo of a {}"], scoring="wpmi",
                                  image_embeds=cv.embedding_table, evidence_ids=ids)
    return {
        "db_shapes": {k: list(np.asarray(v).shape) for k, v in db.items()},
        "clarity": {k: float(np.asarray(clarity[k]).mean()) for k in layers},
        "redundancy": {k: float(np.asarray(redundancy[k])) for k in layers},
        "top": {k: {w: int(np.asarray(s)[i].argmax()) for i, w in enumerate(queries)}
                for k, s in lens.text_probing(queries, agg, templates=["a photo of a {}"]).items()},
        "top5": {k: {w: np.asarray(jscores.topk_cosine_search(q, b, k=5)[1])[i].tolist()
                     for i, w in enumerate(queries)} for k, b in agg.items()},
        "image": {k: int(np.asarray(s).argmax()) for k, s in lens.image_probing(IMAGES[[0, 5]], agg).items()},
        "classes": {k: jscores.class_composition(ids[k], LABELS) for k in layers},
        "labels": {k: [w[0] for w in words[:16]] for k, (words, _) in named.items()},
        "cosines": {k: _cosines64(q, b) for k, b in agg.items()},
    }


def _cosines64(q, bank):
    q, bank = np.asarray(q, np.float64), np.asarray(bank, np.float64)
    norms = np.outer(np.linalg.norm(q, axis=1), np.linalg.norm(bank, axis=1))
    return (q @ bank.T) / np.maximum(norms, 1e-12)


@pytest.mark.parametrize("argv,cls,kw,layers,name", CASES, ids=["convnext", "efficientnet"])
def test_zoo_audit_matches_the_jax_pipeline(monkeypatch, argv, cls, kw, layers, name):
    np_clip = tclip.init_clip_params_jax_layout(1, TINY_T)
    report, model = _run_port(monkeypatch, argv, np_clip)
    assert report["layers"] == layers and model.name == name and report["n_images"] == N
    want = _run_jax(getattr(J, cls)(**kw, dtype=jnp.float32), model.init_jax_layout(0), layers, np_clip)
    assert report["db_shapes"] == want["db_shapes"]
    for layer in layers:
        got = report["scores"][layer]
        assert got["clarity_mean"] == pytest.approx(want["clarity"][layer], rel=1e-5)
        assert got["redundancy"] == pytest.approx(want["redundancy"][layer], rel=1e-5)
        assert [report["component_labels"][layer][str(i)]["word"] for i in range(16)] == want["labels"][layer]
        counts, purity = want["classes"][layer]
        evidence = counts.sum(axis=1)
        eligible = evidence >= max(2, SAMPLES // 2)
        ranked = np.lexsort((-evidence, -np.where(eligible, purity, -1.0)))[:8]
        assert report["class_selective_components"][layer] == {
            str(int(i)): {"purity": round(float(purity[i]), 4), "evidence": int(evidence[i]),
                          "top_class": int(counts[i].argmax())} for i in ranked if eligible[i]}
    assert report["top_neuron_per_query"] == want["top"]
    for layer, per_query in report["top5_per_query"].items():  # equal, up to components whose cosines tie
        cos = want["cosines"][layer]
        for i, (query, ids) in enumerate(per_query.items()):
            np.testing.assert_allclose(cos[i, ids], cos[i, want["top5"][layer][query]], rtol=0, atol=1e-6)
    assert report["image_probe_top_neuron"] == want["image"]
