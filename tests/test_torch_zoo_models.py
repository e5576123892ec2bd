"""The vision zoo's families (part one) against the JAX package: names, specs, defaults and forwards.

- Every variant of every family: ``module_names``, ``_param_specs`` (name,
  JAX-layout shape, init kind) and ``repr`` (the cache names) equal the JAX
  class's. No forward pass.
- ``full_audit``'s default layers and model name for every ``--arch`` /
  ``--variant`` / ``--depth`` of the slice equal the JAX ``tools/full_audit.py``'s,
  read by running the JAX tool's ``main`` up to the visualizer it builds
  (its models' ``init``, the foundation model, ``Lens``, the compilation
  cache and the logging setup replaced by stubs).
- One variant or more per family at a small input (64², VGG-11 headless at
  224²): logits and every tap against the JAX ``apply`` on the same numpy
  weights (JAX ``init``'s kinds drawn by the port, JAX layout → ``convert``),
  float32 on the CPU, within 2e-5 of each value's scale (measured ≤ 4.2e-6).
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import semanticlens_tpu.models as J
import semanticlens_tpu_torch.models as T
from semanticlens_tpu_torch import convert, full_audit

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
REL = 2e-5

VARIANTS = (
    [("ResNet", dict(depth=d)) for d in (18, 34, 50, 101, 152)]
    + [("ResNet", dict(depth=d, variant="d")) for d in (18, 50, 101)]
    + [("ResNet", dict(depth=50, groups=32, width_per_group=4)), ("ResNet", dict(depth=101, groups=32, width_per_group=8)),
       ("ResNet", dict(depth=50, width_per_group=128)), ("ResNet", dict(depth=101, width_per_group=128))]
    + [("VGG", dict(depth=d, batch_norm=bn)) for d in (11, 13, 16, 19) for bn in (False, True)]
    + [("VGG", dict(depth=11, num_classes=0))]
    + [("DenseNet", dict(depth=d)) for d in (121, 161, 169, 201)] + [("DenseNet", dict(depth=121, num_classes=0))]
    + [("ConvNeXt", dict(variant=v, naming=n)) for v in ("tiny", "small", "base", "large")
       for n in ("timm", "torchvision")] + [("ConvNeXt", dict(variant="tiny", num_classes=0))]
    + [("EfficientNet", dict(variant=f"b{i}")) for i in range(8)]
    + [("EfficientNetV2", dict(variant=v)) for v in ("v2_s", "v2_m", "v2_l")]
    + [("MobileNetV2", dict()), ("MobileNetV2", dict(width_mult=0.75)), ("MobileNetV2", dict(num_classes=0))]
    + [("MobileNetV3", dict(variant=v)) for v in ("large", "small")]
    + [("MobileNetV3", dict(variant="small", width_mult=0.75, num_classes=0))]
    + [("MNASNet", dict(variant=v)) for v in ("0_5", "0_75", "1_0", "1_3")]
    + [("RegNet", dict(variant=v)) for v in J.RegNet.VARIANTS]
)


def _id(case):
    cls, kw = case
    return cls + "".join(f"-{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("case", VARIANTS, ids=[_id(c) for c in VARIANTS])
def test_names_specs_and_repr_match_jax(case):
    cls, kw = case
    jm = getattr(J, cls)(**kw, dtype=jnp.float32)
    tm = getattr(T, cls)(**kw, dtype=torch.float32, device="cpu")
    assert tm.module_names == jm.module_names
    assert tm._param_specs() == jm._param_specs()
    assert repr(tm) == repr(jm)


def test_constructor_refusals_match_jax():
    for cls, kw in [("ResNet", dict(depth=18, groups=32)), ("ResNet", dict(variant="e")), ("VGG", dict(depth=12)),
                    ("DenseNet", dict(depth=100)), ("ConvNeXt", dict(variant="huge")),
                    ("ConvNeXt", dict(naming="hf")), ("EfficientNet", dict(variant="b8")),
                    ("EfficientNetV2", dict(variant="v2_xl")), ("MobileNetV3", dict(variant="medium")),
                    ("MNASNet", dict(variant="2_0")), ("RegNet", dict(variant="y_64gf"))]:
        with pytest.raises(ValueError):
            getattr(J, cls)(**kw)
        with pytest.raises(ValueError):
            getattr(T, cls)(**kw, device="cpu")
    for name in ("convnext_tiny", "convnext_large"):
        t, j = T.ConvNeXt.from_name(name, device="cpu"), J.ConvNeXt.from_name(name)
        assert (t.variant, t.naming, t.module_names) == (j.variant, j.naming, j.module_names)
    with pytest.raises(ValueError):
        T.ConvNeXt.from_name("convnext_huge", device="cpu")


# ------------------------------------------------------------- full_audit defaults
AUDIT_ARGS = [["--variant", v] for v in ("d", "x", "wide")] + [["--variant", "x", "--depth", "101"]] + [
    ["--arch", "convnext"] + (["--variant", v] if v else []) for v in ("", "small", "base", "large")] + [
    ["--arch", "vgg"] + (["--depth", str(d)] if d else []) for d in (None, 11, 13, 19)] + [
    ["--arch", "densenet"] + (["--depth", str(d)] if d else []) for d in (None, 161, 169, 201)] + [
    ["--arch", "efficientnet"] + (["--variant", v] if v else []) for v in ("", "b3", "b7", "v2_s", "v2_m", "v2_l")] + [
    ["--arch", "mobilenet"] + (["--variant", v] if v else []) for v in ("", "large", "small")] + [
    ["--arch", "mnasnet"] + (["--variant", v] if v else []) for v in ("", "0_5", "1_3")] + [
    ["--arch", "regnet"] + (["--variant", v] if v else []) for v in ("", "x_400mf", "y_32gf")]


class _Built(Exception):
    """Raised by the stub visualizer: carries the JAX tool's model and layers."""


def _jax_tool_defaults(monkeypatch, argv):
    """``(model, layers)`` as the JAX ``tools/full_audit.py`` builds them, its weights and FM stubbed."""
    import semanticlens_tpu
    import semanticlens_tpu.collect
    import semanticlens_tpu.core
    import semanticlens_tpu.foundation_models
    import semanticlens_tpu.utils

    spec = importlib.util.spec_from_file_location("jax_full_audit_tool", REPO / "tools" / "full_audit.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for name in ("ResNet", "ConvNeXt", "VGG", "DenseNet", "EfficientNet", "EfficientNetV2", "MobileNetV2",
                 "MobileNetV3", "MNASNet", "RegNet"):
        monkeypatch.setattr(getattr(J, name), "init", lambda self, rng: {})
    monkeypatch.setattr(semanticlens_tpu.core, "enable_compilation_cache", lambda *a, **k: None)
    # the tool's logging setup would replace the package logger's NullHandler for the rest of the process
    monkeypatch.setattr(semanticlens_tpu.utils, "setup_colored_logging", lambda *a, **k: None)
    monkeypatch.setattr(semanticlens_tpu.foundation_models, "create", lambda *a, **k: None)
    monkeypatch.setattr(semanticlens_tpu, "Lens", lambda fm: None)

    def stop(model, layer_names, **_):
        raise _Built(model, layer_names)

    monkeypatch.setattr(semanticlens_tpu.collect, "ActivationComponentVisualizer", stop)
    monkeypatch.setattr(sys, "argv", ["full_audit.py", "--no-mesh", "--n-synthetic", "1", "--image-size", "8", *argv])
    with pytest.raises(_Built) as built:
        tool.main()
    return built.value.args


@pytest.mark.parametrize("argv", AUDIT_ARGS, ids=[" ".join(a) for a in AUDIT_ARGS])
def test_full_audit_default_layers_and_names_are_the_jax_tools(monkeypatch, argv):
    jmodel, jlayers = _jax_tool_defaults(monkeypatch, argv)
    args = full_audit.parse_args(argv)
    model, layers, name = full_audit._zoo_model(args, "cpu")
    assert (layers, name, repr(model)) == (list(jlayers), jmodel.name, repr(jmodel))
    assert set(layers) <= set(model.module_names)


# ------------------------------------------------------------- forwards
FORWARDS = [
    ("ResNet", dict(depth=50, variant="d"), 64),
    ("ResNet", dict(depth=50, groups=32, width_per_group=4), 64),
    ("ResNet", dict(depth=50, width_per_group=128), 64),
    ("VGG", dict(depth=11, num_classes=0, batch_norm=True), 224),
    ("DenseNet", dict(depth=121), 64),
    ("ConvNeXt", dict(variant="tiny"), 64),
    ("ConvNeXt", dict(variant="tiny", naming="torchvision"), 64),
    ("EfficientNet", dict(variant="b0"), 64),
    ("EfficientNet", dict(variant="b5"), 32),  # BN eps 1e-3
    ("EfficientNetV2", dict(variant="v2_s"), 64),
    ("MobileNetV2", dict(), 64),
    ("MobileNetV3", dict(variant="large"), 64),
    ("MobileNetV3", dict(variant="small"), 64),
    ("MNASNet", dict(variant="1_0"), 64),
    ("RegNet", dict(variant="y_400mf"), 64),
    ("RegNet", dict(variant="x_400mf"), 64),
]


def zoo_pair(cls, kw, seed=0):
    """(JAX model, its params, port model, its params) on one set of numpy weights, float32 on the CPU."""
    jm = getattr(J, cls)(**kw, dtype=jnp.float32)
    tm = getattr(T, cls)(**kw, dtype=torch.float32, device="cpu")
    weights = tm.init_jax_layout(seed)
    return jm, {k: jnp.asarray(v) for k, v in weights.items()}, tm, tm.load_jax_params(weights)


def _gap(got, want):
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("cls,kw,size", FORWARDS, ids=[_id(c[:2]) for c in FORWARDS])
def test_logits_and_every_tap_match_jax(cls, kw, size):
    jm, jp, tm, tp = zoo_pair(cls, kw)
    x = np.random.default_rng(1).normal(size=(2, size, size, 3)).astype(np.float32)
    names = tuple(jm.module_names)
    jout, jtaps = jax.jit(lambda p, xx: jm.apply(p, xx, names))(jp, jnp.asarray(x))
    with torch.no_grad():
        tout, ttaps = tm.apply(tp, torch.from_numpy(x), names)
    assert set(ttaps) == set(jtaps)
    assert len(ttaps) >= len(names) - 2  # ResNet-D's stem ReLUs conv1.2 / conv1.5 are named, not tapped
    assert tout.shape == jout.shape and _gap(tout.numpy(), jout) <= REL
    for name, want in jtaps.items():
        assert ttaps[name].shape == want.shape, name
        assert _gap(ttaps[name].numpy(), want) <= REL, name


def test_vgg_pool_refuses_a_feature_map_that_does_not_pool_to_7x7():
    for model in (J.VGG(depth=11, num_classes=0, dtype=jnp.float32), T.VGG(depth=11, num_classes=0,
                                                                            dtype=torch.float32, device="cpu")):
        x = np.zeros((1, 64, 64, 3), np.float32)
        specs = [s for s in model._param_specs() if s[0].startswith("features.")]  # raised before the classifier
        params = {k: np.zeros(s, np.float32) for k, s, _ in specs}
        with pytest.raises(ValueError, match="pool to 7x7"):
            if isinstance(model, T.VGG):
                model.apply(convert.zoo_params_from_jax(params, specs), torch.from_numpy(x))
            else:
                model.apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))


def test_bf16_forward_runs_in_channels_last_and_keeps_the_dtype():
    """bf16 on the CPU: the forward stays in the compute dtype and memory format; taps come back NHWC."""
    tm = T.ConvNeXt(variant="tiny", dtype=torch.bfloat16, device="cpu")
    params = tm.init(seed=0)
    assert params["stages.0.blocks.0.conv_dw.weight"].is_contiguous(memory_format=torch.channels_last)
    assert params["stages.0.blocks.0.gamma"].dtype == torch.float32
    with torch.no_grad():
        logits, taps = tm.apply(params, torch.rand(2, 64, 64, 3), ("stages.1", "stages.1.blocks.0.mlp.fc1"))
    assert logits.dtype == torch.bfloat16 and logits.shape == (2, 1000)
    assert taps["stages.1"].shape == (2, 8, 8, 192) and taps["stages.1.blocks.0.mlp.fc1"].shape == (2, 8, 8, 768)
    assert torch.isfinite(logits.float()).all()
