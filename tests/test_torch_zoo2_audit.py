"""``full_audit --cpu --arch X`` for part-two families against the pipeline composed from JAX calls.

The method of ``test_torch_zoo_audit.py`` (its ``_run_port`` / ``_run_jax``):
the port's own ``build_model`` runs (``--arch`` / ``--variant``: the
family's default layers and model name), its subject re-placed in float32
from the same seed; the foundation model is the cut-down CLIP and the data
the 24 labelled 32² images of ``test_torch_full_audit.py``. The report's
keys, DB shapes, clarity and redundancy per layer (1e-5 relative), top
neuron per query, image probe, class-selective components and soft-WPMI
labels equal the JAX pipeline's; the top-5 per query is equal up to order
among components whose float64 cosines tie within 1e-6. Two families:
Swin-T (its 32² input shrinks to 1×1 by the last stage, so every window
covers its map and the shift clamps to 0) and ShuffleNetV2 ×1.0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import semanticlens_tpu.models as J
from semanticlens_tpu_torch import full_audit
from semanticlens_tpu_torch.foundation_models import clip as tclip
from test_torch_full_audit import N, TINY_T
from test_torch_zoo_audit import SAMPLES, _run_jax, _run_port

torch.set_num_threads(2)

CASES = [
    (["--arch", "swin"], "SwinTransformer", dict(variant="tiny"), [f"features.{i}" for i in (1, 3, 5, 7)],
     "swin-tiny-audit"),
    (["--arch", "shufflenet"], "ShuffleNetV2", dict(variant="x1_0"), ["stage2", "stage3", "stage4", "conv5"],
     "shufflenet_v2_x1_0-audit"),
]


@pytest.mark.parametrize("argv,cls,kw,layers,name", CASES, ids=["swin", "shufflenet"])
def test_zoo2_audit_matches_the_jax_pipeline(monkeypatch, argv, cls, kw, layers, name):
    np_clip = tclip.init_clip_params_jax_layout(1, TINY_T)
    report, model = _run_port(monkeypatch, argv, np_clip)
    assert tuple(report) == full_audit.REPORT_KEYS
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
