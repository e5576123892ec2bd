"""The vision zoo's families, part two, against the JAX package: names, specs, defaults and forwards.

- Every variant of Swin / Swin-V2, MaxViT, GoogLeNet, Inception-v3,
  ShuffleNetV2, AlexNet and SqueezeNet: ``module_names``, ``_param_specs``
  (name, JAX-layout shape, init kind) and ``repr`` (the cache names) equal
  the JAX class's. No forward pass.
- ``full_audit``'s default layers and model name for each new ``--arch`` /
  ``--variant`` equal the JAX ``tools/full_audit.py``'s, read by running the
  JAX tool's ``main`` up to the visualizer it builds (its models' ``init``,
  the foundation model, ``Lens``, the compilation cache and the logging
  setup replaced by stubs).
- Forwards at published width on small inputs: logits and every tap against
  the JAX ``apply`` (jitted) on the same numpy weights, float32 on the CPU,
  within 2e-5 of each value's scale (measured ≤ 3.5e-6). Swin and Swin-V2
  run at 56² and at 60² (padding to the window, the shift clamp, odd-size
  patch merging), SqueezeNet at odd sizes (``ceil_mode`` pools), MaxViT-T at
  224² (its only size class). Bias tables and CPB weights are drawn with a
  trained model's spread, the JAX init's being zero or near it.
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
FAMILIES = ("SwinTransformer", "SwinTransformerV2", "MaxViT", "GoogLeNet", "InceptionV3", "ShuffleNetV2", "AlexNet",
            "SqueezeNet")

VARIANTS = (
    [("SwinTransformer", dict(variant=v)) for v in ("tiny", "small", "base")]
    + [("SwinTransformerV2", dict(variant=v)) for v in ("tiny", "small", "base")]
    + [("SwinTransformer", dict(num_classes=0)), ("SwinTransformerV2", dict(num_classes=0))]
    + [("MaxViT", dict()), ("MaxViT", dict(num_classes=0)), ("MaxViT", dict(partition_size=2))]
    + [("GoogLeNet", dict()), ("GoogLeNet", dict(num_classes=0, transform_input=True))]
    + [("InceptionV3", dict()), ("InceptionV3", dict(num_classes=0, transform_input=True))]
    + [("ShuffleNetV2", dict(variant=v)) for v in ("x0_5", "x1_0", "x1_5", "x2_0")]
    + [("ShuffleNetV2", dict(num_classes=0))]
    + [("AlexNet", dict()), ("AlexNet", dict(num_classes=0))]
    + [("SqueezeNet", dict(version=v)) for v in ("1_0", "1_1")] + [("SqueezeNet", dict(num_classes=0))]
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
    for cls, kw in [("SwinTransformer", dict(variant="large")), ("SwinTransformerV2", dict(variant="huge")),
                    ("MaxViT", dict(variant="small")), ("ShuffleNetV2", dict(variant="x3_0")),
                    ("SqueezeNet", dict(version="1_2"))]:
        with pytest.raises(ValueError):
            getattr(J, cls)(**kw)
        with pytest.raises(ValueError):
            getattr(T, cls)(**kw, device="cpu")


# ------------------------------------------------------------- full_audit defaults
AUDIT_ARGS = ([["--arch", a] + (["--variant", v] if v else []) for a in ("swin", "swin_v2") for v in ("", "small", "base")]
              + [["--arch", "inception"] + (["--variant", v] if v else []) for v in ("", "v1", "v3")]
              + [["--arch", "shufflenet"] + (["--variant", v] if v else []) for v in ("", "x0_5", "x1_5", "x2_0")]
              + [["--arch", "maxvit"], ["--arch", "alexnet"]]
              + [["--arch", "squeezenet"] + (["--variant", v] if v else []) for v in ("", "1_1")])


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
    for name in FAMILIES:
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


def test_every_jax_arch_is_accepted():
    for arch in full_audit.ARCHES:
        assert full_audit.parse_args(["--arch", arch]).arch == arch


# ------------------------------------------------------------- forwards
FORWARDS = [
    ("SwinTransformer", dict(), 56, 2),
    ("SwinTransformer", dict(), 60, 2),
    ("SwinTransformerV2", dict(), 56, 2),
    ("SwinTransformerV2", dict(), 60, 2),
    ("MaxViT", dict(), 224, 1),
    ("GoogLeNet", dict(transform_input=True), 64, 2),
    ("InceptionV3", dict(), 80, 2),
    ("ShuffleNetV2", dict(variant="x0_5"), 64, 2),
    ("ShuffleNetV2", dict(variant="x1_0"), 64, 2),
    ("ShuffleNetV2", dict(variant="x1_5"), 64, 2),
    ("ShuffleNetV2", dict(variant="x2_0"), 64, 2),
    ("AlexNet", dict(num_classes=0), 224, 2),
    ("SqueezeNet", dict(version="1_0"), 67, 2),
    ("SqueezeNet", dict(version="1_1"), 69, 2),
]


def trained_spread(weights, seed=3):
    """The JAX init's zero bias tables and near-zero CPB MLPs given a trained model's spread (tables N(0, 1),
    CPB weights + N(0, 0.2)), so that the bias paths show."""
    rng = np.random.default_rng(seed)
    out = dict(weights)
    for name, value in weights.items():
        if name.endswith("relative_position_bias_table"):
            out[name] = rng.normal(0, 1.0, value.shape).astype(np.float32)
        elif ".cpb_mlp." in name:
            out[name] = (value + rng.normal(0, 0.2, value.shape)).astype(np.float32)
    return out


def zoo2_pair(cls, kw, seed=0, dtype=(jnp.float32, torch.float32)):
    """(JAX model, its params, port model, its params) on one set of numpy weights, on the CPU."""
    jm = getattr(J, cls)(**kw, dtype=dtype[0])
    tm = getattr(T, cls)(**kw, dtype=dtype[1], device="cpu")
    weights = trained_spread(tm.init_jax_layout(seed))
    return jm, {k: jnp.asarray(v) for k, v in weights.items()}, tm, tm.load_jax_params(weights)


def _gap(got, want):
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("cls,kw,size,batch", FORWARDS, ids=[f"{_id(c[:2])}-{c[2]}" for c in FORWARDS])
def test_logits_and_every_tap_match_jax(cls, kw, size, batch):
    jm, jp, tm, tp = zoo2_pair(cls, kw)
    x = np.random.default_rng(1).normal(size=(batch, size, size, 3)).astype(np.float32)
    names = tuple(jm.module_names)
    jout, jtaps = jax.jit(lambda p, xx: jm.apply(p, xx, names))(jp, jnp.asarray(x))
    with torch.no_grad():
        tout, ttaps = tm.apply(tp, torch.from_numpy(x), names)
    assert set(ttaps) == set(jtaps)
    assert len(ttaps) >= len(names) - 1  # ShuffleNet's and SqueezeNet's headless pool is functional, untapped
    assert tout.shape == jout.shape and _gap(tout.numpy(), jout) <= REL
    for name, want in jtaps.items():
        assert ttaps[name].shape == want.shape, name
        assert _gap(ttaps[name].numpy(), want) <= REL, name


def test_maxvit_refuses_a_size_off_the_partition_as_jax_does():
    """A 112² input reaches stage 3 at 7×7 → 4×4 (not a multiple of 7): both packages raise there, naming the
    partition. Driven at the first partition attention, with a 16×16 map."""
    from semanticlens_tpu.models import base as jbase
    from semanticlens_tpu_torch.models import base as tbase

    at = "blocks.0.layers.0.layers.window_attention"
    for model, tap, x in ((J.MaxViT(dtype=jnp.float32), jbase.TapCollector(()), jnp.zeros((1, 16, 16, 64))),
                          (T.MaxViT(dtype=torch.float32, device="cpu"), tbase.TapCollector(()),
                           torch.zeros(1, 16, 16, 64))):
        with pytest.raises(ValueError, match="not divisible by partition"):
            model._partition_attention({}, x, at, 2, "window", tap)


def test_alexnet_pool_refuses_a_feature_map_that_does_not_pool_to_6x6():
    for model in (J.AlexNet(num_classes=0, dtype=jnp.float32), T.AlexNet(num_classes=0, dtype=torch.float32,
                                                                         device="cpu")):
        x = np.zeros((1, 127, 127, 3), np.float32)
        specs = model._param_specs()
        params = {k: np.zeros(s, np.float32) for k, s, _ in specs}
        with pytest.raises(ValueError, match="pool to 6x6"):
            if isinstance(model, T.AlexNet):
                model.apply(convert.zoo_params_from_jax(params, specs), torch.from_numpy(x))
            else:
                model.apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))


@pytest.mark.parametrize("size", [13, 14, 15, 16, 17, 28, 55, 56, 57])
def test_ceil_mode_max_pool_is_the_jax_emulation(size):
    """torch's ``ceil_mode`` against the JAX package's ``_ceil_extra_pad`` at odd and even sizes, the pools of
    SqueezeNet (3/2/0) and GoogLeNet (3/2/0, 2/2/0, 3/1/1)."""
    from semanticlens_tpu.models import layers as jl
    from semanticlens_tpu_torch.models import layers as tl

    x = np.random.default_rng(size).normal(size=(2, size, size + 2, 5)).astype(np.float32)
    for window, stride, padding in ((3, 2, 0), (2, 2, 0), (3, 1, 1), (3, 2, 1)):
        want = np.asarray(jl.max_pool(jnp.asarray(x), window=window, stride=stride, padding=padding, ceil_mode=True))
        got = tl.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), window=window, stride=stride, padding=padding,
                          ceil_mode=True).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)


def test_bf16_swin_keeps_bias_tables_float32_and_runs_channels_last():
    """bf16 on the CPU: the tables stay float32, the forward keeps the compute dtype, taps come back NHWC."""
    tm = T.SwinTransformer(dtype=torch.bfloat16, device="cpu")
    params = tm.init(seed=0)
    assert params["features.1.0.attn.relative_position_bias_table"].dtype == torch.float32
    assert params["features.1.0.attn.qkv.weight"].dtype == torch.bfloat16
    assert params["features.0.0.weight"].is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        logits, taps = tm.apply(params, torch.rand(2, 64, 64, 3), ("features.1", "features.5", "features.2.norm"))
    assert logits.dtype == torch.bfloat16 and logits.shape == (2, 1000)
    assert taps["features.1"].shape == (2, 16, 16, 96) and taps["features.5"].shape == (2, 4, 4, 384)
    assert taps["features.2.norm"].shape == (2, 8, 8, 384)
    assert torch.isfinite(logits.float()).all()
