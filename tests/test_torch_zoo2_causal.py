"""Interventions on the convolutional families of the vision zoo's part two, and ``causal_audit``'s names.

- ``causal.ablation_effects`` on one tap per family (zero or mean ablation,
  alternating): the Δ of each ablated component equals the JAX package's
  within 1e-5 of the logits' scale, float32 on the CPU (a Δ is the
  difference of two float32 forwards, so its error follows the logits).
  Swin's and MaxViT's are in ``test_torch_zoo2_interventions.py``.
- ``causal_audit.build_model`` builds, for every part-two name of
  ``tools/bench_subject.py``, the class and configuration the JAX
  ``build_model`` builds (same ``repr`` and ``module_names``), and
  ``causal_audit.main`` runs a ShuffleNet on the CPU.
"""

import argparse

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu import causal as jcausal
from semanticlens_tpu_torch import causal as tcausal
from semanticlens_tpu_torch import causal_audit

from test_torch_zoo2_models import zoo2_pair
from test_torch_zoo_causal import _JittedClean, _jax_bench_subject

torch.set_num_threads(2)

ABLATIONS = [
    ("GoogLeNet", dict(), "inception4c", 64, "mean"),
    ("InceptionV3", dict(), "Mixed_6b", 80, "zero"),
    ("ShuffleNetV2", dict(variant="x1_0"), "stage3", 64, "mean"),
    ("AlexNet", dict(), "features.7", 224, "zero"),
    ("SqueezeNet", dict(version="1_1"), "features.7", 67, "mean"),
]


@pytest.mark.parametrize("cls,kw,layer,size,mode", ABLATIONS, ids=[f"{c[0]}-{c[2]}-{c[4]}" for c in ABLATIONS])
def test_ablation_effects_match_jax(cls, kw, layer, size, mode):
    jm, jp, tm, tp = zoo2_pair(cls, kw)
    batch = 2
    x = np.random.default_rng(2).random((batch, size, size, 3)).astype(np.float32)
    ids = [0, 3, 5]
    want = np.asarray(jcausal.ablation_effects(_JittedClean(jm), jp, layer, jnp.asarray(x), ids, mode=mode))
    with torch.no_grad():
        clean = tm.apply(tp, torch.from_numpy(x))[0].numpy()
    got = tcausal.ablation_effects(tm, tp, layer, x, ids, mode=mode).numpy()
    assert got.shape == want.shape == (3, batch, clean.shape[-1])
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(clean).max()


NAMES = [("swin", {}), ("swin", {"variant": "small"}), ("swin_v2", {}), ("swin_v2", {"variant": "base"}),
         ("googlenet", {}), ("inception_v3", {}), ("shufflenet", {}), ("shufflenet", {"variant": "x2_0"}),
         ("alexnet", {}), ("squeezenet", {}), ("squeezenet", {"variant": "1_1"}), ("maxvit", {})]


@pytest.mark.parametrize("arch,extra", NAMES, ids=[a + "".join(f"-{v}" for v in e.values()) for a, e in NAMES])
def test_causal_audit_builds_the_jax_subject(arch, extra):
    args = argparse.Namespace(**{"arch": arch, "depth": 50, "variant": "", "image_size": 224, "dtype": "float32",
                                 **extra})
    want = _jax_bench_subject().build_model(args, jnp)
    got = causal_audit.build_model(args, "cpu")
    assert type(got).__name__ == type(want).__name__
    assert repr(got) == repr(want) and got.module_names == want.module_names
    assert got.dtype == torch.float32


def test_causal_audit_cli_runs_a_part_two_subject():
    """``causal_audit.main --cpu --arch shufflenet`` end to end at a small size: one line per component and the
    summary, every ratio finite."""
    report = causal_audit.main(["--cpu", "--arch", "shufflenet", "--variant", "x0_5", "--layer", "stage3",
                                "--images", "16", "--image-size", "32", "--components", "3", "--evidence", "2",
                                "--batch", "8"])
    assert tuple(report) == causal_audit.REPORT_KEYS and report["layer"] == "stage3"
    assert report["components"] == 3 and np.isfinite(report["median_ratio"])
