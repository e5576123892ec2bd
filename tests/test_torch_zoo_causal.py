"""Interventions on the vision zoo's taps, and ``causal_audit``'s zoo names, against the JAX package.

- ``causal.ablation_effects`` on one tap per family (zero or mean ablation,
  alternating): the Δ of each ablated component equals the JAX package's
  within 1e-5 of the logits' scale, float32 on the CPU (a Δ is the
  difference of two float32 forwards, so its error follows the logits;
  ``CAUSAL_GATE`` in chip_smoke.py).
- ``causal_audit.build_model`` builds, for every ``tools/bench_subject.py``
  name of this slice, the class and configuration the JAX ``build_model``
  builds (same ``repr``); part two's names are held in
  ``test_torch_zoo2_causal.py``.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import semanticlens_tpu.models as J
from semanticlens_tpu import causal as jcausal
from semanticlens_tpu.models import base as jbase
import semanticlens_tpu_torch.models as T
from semanticlens_tpu_torch import causal as tcausal
from semanticlens_tpu_torch import causal_audit

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

ABLATIONS = [
    ("ResNet", dict(depth=50, variant="d"), "layer2", 32, "zero"),
    ("VGG", dict(depth=11), "features.10", 224, "mean"),
    ("DenseNet", dict(depth=121), "features.denseblock2", 32, "zero"),
    ("ConvNeXt", dict(variant="tiny"), "stages.1.blocks.2.mlp.fc1", 64, "mean"),
    ("EfficientNet", dict(variant="b0"), "features.4", 32, "zero"),
    ("EfficientNetV2", dict(variant="v2_s"), "features.3", 32, "mean"),
    ("MobileNetV2", dict(), "features.7", 32, "zero"),
    ("MobileNetV3", dict(variant="small"), "features.4.block.2", 32, "mean"),
    ("MNASNet", dict(variant="1_0"), "layers.10", 32, "zero"),
    ("RegNet", dict(variant="y_400mf"), "trunk_output.block2", 32, "mean"),
]


class _JittedClean(jbase.SubjectModel):
    """A JAX model whose clean forwards run jitted (the JAX ``ablation_effects`` runs its clean pass eagerly,
    op by op, which takes tens of seconds on the CPU for DenseNet); forwards under an intervention, or
    traced inside the JAX package's own program, are the model's ``apply`` as it is."""

    def __init__(self, model):
        self.model, self.module_names = model, model.module_names

    def apply(self, params, x, tap_names=()):
        if jbase.interventions_fingerprint() or isinstance(x, jax.core.Tracer):
            return self.model.apply(params, x, tap_names)
        return jax.jit(lambda p, xx: self.model.apply(p, xx, tuple(tap_names)))(params, x)


@pytest.mark.parametrize("cls,kw,layer,size,mode", ABLATIONS, ids=[f"{c[0]}-{c[2]}-{c[4]}" for c in ABLATIONS])
def test_ablation_effects_match_jax(cls, kw, layer, size, mode):
    jm = getattr(J, cls)(**kw, dtype=jnp.float32)
    tm = getattr(T, cls)(**kw, dtype=torch.float32, device="cpu")
    weights = tm.init_jax_layout(0)
    jp, tp = {k: jnp.asarray(v) for k, v in weights.items()}, tm.load_jax_params(weights)
    x = np.random.default_rng(2).random((2, size, size, 3)).astype(np.float32)
    ids = [0, 3, 5]
    want = np.asarray(jcausal.ablation_effects(_JittedClean(jm), jp, layer, jnp.asarray(x), ids, mode=mode))
    with torch.no_grad():
        clean = tm.apply(tp, torch.from_numpy(x))[0].numpy()
    got = tcausal.ablation_effects(tm, tp, layer, x, ids, mode=mode).numpy()
    assert got.shape == want.shape == (3, 2, clean.shape[-1])
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(clean).max()


def _jax_bench_subject():
    sys.path.insert(0, str(REPO))
    try:
        from tools import bench_subject
    finally:
        sys.path.remove(str(REPO))
    return bench_subject


NAMES = [("convnext", {}), ("convnext", {"variant": "small"}), ("vgg", {}), ("vgg", {"depth": 19}),
         ("densenet", {}), ("densenet", {"depth": 169}), ("efficientnet", {}), ("efficientnet", {"variant": "b4"}),
         ("efficientnet_v2", {}), ("efficientnet_v2", {"variant": "v2_m"}), ("mobilenetv2", {}),
         ("mobilenetv3", {}), ("mobilenetv3", {"variant": "small"}), ("resnext", {}), ("resnext", {"depth": 101}),
         ("wide_resnet", {}), ("regnet", {}), ("regnet", {"variant": "x_8gf"}), ("mnasnet", {}),
         ("mnasnet", {"variant": "0_5"}), ("resnet", {"depth": 18}), ("vit", {})]


@pytest.mark.parametrize("arch,extra", NAMES, ids=[a + "".join(f"-{v}" for v in e.values()) for a, e in NAMES])
def test_causal_audit_builds_the_jax_subject(arch, extra):
    args = argparse.Namespace(**{"arch": arch, "depth": 50, "variant": "", "image_size": 32, "dtype": "float32",
                                 **extra})
    want = _jax_bench_subject().build_model(args, jnp)
    got = causal_audit.build_model(args, "cpu")
    assert type(got).__name__ == type(want).__name__
    assert repr(got) == repr(want) and got.module_names == want.module_names
    assert got.dtype == torch.float32

