"""LRP through the vision zoo's blocks against the JAX package.

- One block per family (and a stem-to-tap stretch for VGG and DenseNet,
  whose blocks are not methods) under the ε and ε-plus-flat composites:
  the port's ``torch.autograd`` VJP against ``jax.vjp`` under the JAX
  composite (jitted), on the same numpy weights and inputs, float32 on the
  CPU. The blocks cover what the zoo adds to the rule stream: grouped and
  depthwise convs, the -D avg-pool shortcut, SE gates (CP-LRP constants),
  channel concatenation, the channels-last LayerNorm and layer scale,
  ReLU6 and hardswish pass-through, proportional residual splits.
- The conservation mirrors of JAX ``tests/models/test_lrp_new_families.py``
  (RegNet-Y block, MNASNet residual block, EfficientNetV2 fused block) on
  the port alone, plus a ConvNeXt block and a MobileNetV3 SE block, and a
  ReLU6 unit saturated at 6 that keeps its relevance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import semanticlens_tpu.models as J
from semanticlens_tpu.models import base as jbase
from semanticlens_tpu.models import layers as jl
import semanticlens_tpu_torch.models as T
from semanticlens_tpu_torch.models import base as tbase
from semanticlens_tpu_torch.models import layers as tl

torch.set_num_threads(2)

RELEVANCE_REL = 5e-4


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _block_fns(cls, kw, jm, jp, tm, tp):
    """(JAX fn NHWC → NHWC, port fn NCHW → NCHW, input shape NHWC) of the case's block."""
    jt, tt = jbase.TapCollector(()), tbase.TapCollector((), channels_first=True)
    if cls == "ResNet":  # the -D avg-pool shortcut, or the grouped 3×3
        return (lambda x: jm._bottleneck_block(jp, "layer2.0", x, 2, jt),
                lambda x: tm._bottleneck_block(tp, "layer2.0", x, 2, tt), (2, 8, 8, 256))
    if cls in ("VGG", "DenseNet"):  # stem to a tap through the model's apply
        layer, shape = ("features.5", (1, 224, 224, 3)) if cls == "VGG" else ("features.denseblock1", (2, 32, 32, 3))
        return (lambda x: jm.apply(jp, x, (layer,))[1][layer],
                lambda x: tm.apply(tp, x.permute(0, 2, 3, 1), (layer,))[1][layer].permute(0, 3, 1, 2), shape)
    if cls == "ConvNeXt":
        return (lambda x: jm._block(lambda k: jp[k], "stages.0.blocks.1", x, jt),
                lambda x: tm._block(lambda k: tp[k], "stages.0.blocks.1", x, tt), (2, 8, 8, 96))
    if cls == "EfficientNet":
        cfg = jm.stages[1][1]  # MBConv with SE, residual
        return (lambda x: jm._mbconv(jp, x, "features.2.1", cfg, jt),
                lambda x: tm._mbconv(tp, x, "features.2.1", tm.stages[1][1], tt), (2, 8, 8, cfg.c_in))
    if cls == "EfficientNetV2":
        cfg = jm.stages[1][1]  # fused, expand 4, residual
        return (lambda x: jm._fused_mbconv(jp, x, "features.2.1", cfg, jt),
                lambda x: tm._fused_mbconv(tp, x, "features.2.1", tm.stages[1][1], tt), (2, 8, 8, cfg.c_in))
    if cls == "MobileNetV2":
        blk = jm.blocks[2]  # ReLU6 expand + depthwise, residual
        return (lambda x: jm._inverted_residual(jp, x, "features.3", blk, jt),
                lambda x: tm._inverted_residual(tp, x, "features.3", tm.blocks[2], tt), (2, 8, 8, blk.c_in))
    if cls == "MobileNetV3":
        i = kw["block"]  # 4: ReLU + SE, 11: hardswish + SE; both residual
        blk = jm.blocks[i]
        return (lambda x: jm._bneck(jp, x, f"features.{i + 1}", blk, jt),
                lambda x: tm._bneck(tp, x, f"features.{i + 1}", tm.blocks[i], tt), (2, 8, 8, blk.c_in))
    if cls == "MNASNet":
        blk = jm.stacks[0][1]
        return (lambda x: jm._ir_block(jp, x, "layers.8.1", blk, jt),
                lambda x: tm._ir_block(tp, x, "layers.8.1", tm.stacks[0][1], tt), (2, 8, 8, blk.c_in))
    blk = jm.stages[1][0]  # RegNet-Y: proj shortcut, grouped conv, SE
    return (lambda x: jm._block(jp, x, "trunk_output.block2.block2-0", blk, jt),
            lambda x: tm._block(tp, x, "trunk_output.block2.block2-0", tm.stages[1][0], tt), (2, 8, 8, blk.c_in))


BLOCKS = [
    ("ResNet", dict(depth=50, variant="d")),
    ("ResNet", dict(depth=50, groups=32, width_per_group=4)),
    ("VGG", dict(depth=11, batch_norm=True)),
    ("DenseNet", dict(depth=121)),
    ("ConvNeXt", dict(variant="tiny")),
    ("EfficientNet", dict(variant="b0")),
    ("EfficientNetV2", dict(variant="v2_s")),
    ("MobileNetV2", dict()),
    ("MobileNetV3", dict(variant="large", block=4)),
    ("MobileNetV3", dict(variant="large", block=11)),
    ("MNASNet", dict(variant="0_5")),
    ("RegNet", dict(variant="y_400mf")),
]


def _id(case):
    cls, kw = case
    return cls + "".join(f"-{k}={v}" for k, v in kw.items())


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# Blocks whose z⁺ convs see signed inputs inside (SiLU and hardswish outputs): their denominators
# f₊(x) + ε come near 0 and float32 is ill-conditioned in both packages (the port's and the JAX package's
# relevance part by 9e-4 / 5.7e-3 of the scale here; fed signed inputs, EfficientNetV2's fused block moves
# by ~5× its scale from float64 in the port and ~0.7× in the JAX package). Under ε-plus-flat they are held
# to the JAX rule stream and forward, not to its relevance values.
SIGNED_Z_PLUS = {"EfficientNet-variant=b0", "MobileNetV3-variant=large-block=11"}


@pytest.fixture(scope="module", params=BLOCKS, ids=[_id(c) for c in BLOCKS])
def block(request):
    """(case id, JAX block fn, port block fn, input shape NHWC) on one set of numpy weights."""
    cls, kw = request.param
    model_kw = {k: v for k, v in kw.items() if k != "block"}
    jm = getattr(J, cls)(**model_kw, dtype=jnp.float32)
    tm = getattr(T, cls)(**model_kw, dtype=torch.float32, device="cpu")
    # Non-zero BN statistics and biases, so the ε denominators see the shifts the rules must carry.
    rng = np.random.default_rng(3)
    weights = tm.init_jax_layout(0)
    for name, shape, kind in tm._param_specs():
        if name.endswith(("running_mean", ".bias")):
            weights[name] = rng.normal(0, 0.1, shape).astype(np.float32)
        elif name.endswith("running_var"):
            weights[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in weights.items()}
    return (_id(request.param), *_block_fns(cls, kw, jm, jp, tm, tm.load_jax_params(weights)))


@pytest.mark.parametrize("composite,skip", [("epsilon", 0), ("epsilon_plus_flat", 0), ("epsilon_plus_flat", 1)],
                         ids=["epsilon", "flat-first", "zplus"])
def test_block_relevance_matches_jax(block, composite, skip):
    """The same number of rule-bearing ops, the forward within 2e-5 of its scale, the input relevance within
    ``RELEVANCE_REL`` of its scale (measured ≤ 4.0e-4: EfficientNetV2's fused block under ε; VGG's ε
    stretch 2.2e-4, as far from float64 as the JAX package's). Block inputs are non-negative, as after a
    ReLU."""
    case, jfn, tfn, shape = block
    x = np.abs(np.random.default_rng(7).normal(size=shape)).astype(np.float32)
    seen = {}

    def jvjp(xx):
        with jl.lrp_composite(composite, epsilon=1e-6):
            for _ in range(skip):
                jl._next_rule("conv")
            out, vjp = jax.vjp(jfn, xx)
            seen["jax"] = jl._LRP.n_linear_seen
            return out, vjp(out)[0]

    jout, jrel = jax.jit(jvjp)(jnp.asarray(x))
    xt = _nchw(x).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    with tl.lrp_composite(composite, epsilon=1e-6):
        for _ in range(skip):
            tl._next_rule("conv")
        tout = tfn(xt)
        seen["port"] = tl._LRP.n_linear_seen
    (trel,) = torch.autograd.grad(tout, xt, tout.detach())
    assert seen["port"] == seen["jax"] > skip
    assert _rel(tout.detach().permute(0, 2, 3, 1).numpy(), jout) <= 2e-5
    assert torch.isfinite(trel).all()
    if composite == "epsilon" or case not in SIGNED_Z_PLUS:
        assert _rel(trel.permute(0, 2, 3, 1).numpy(), jrel) <= RELEVANCE_REL


# ------------------------------------------------------------- conservation (port alone)
def _zeroed(params):
    return {k: torch.zeros_like(v) if k.endswith((".bias", ".running_mean")) else v for k, v in params.items()}


def _conserves(fn, x, rtol):
    xx = x.clone().contiguous(memory_format=torch.channels_last).requires_grad_(True)
    with tl.lrp_composite("epsilon", epsilon=1e-9):
        out = fn(xx)
    (r_in,) = torch.autograd.grad(out, xx, out.detach())
    np.testing.assert_allclose(float(r_in.double().sum()), float(out.detach().double().sum()), rtol=rtol)


def _model(cls, **kw):
    tm = getattr(T, cls)(**kw, num_classes=0, dtype=torch.float32, device="cpu")
    return tm, _zeroed(tm.init(seed=0))


def _x(seed, shape, positive=False):
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))
    return (x.abs() if positive else x).permute(0, 3, 1, 2)


def test_regnet_block_conserves():
    """RegNet-Y bottleneck: grouped conv, SE constant gate, proj shortcut with a proportional split."""
    tm, params = _model("RegNet", variant="y_400mf")
    blk = tm.stages[1][0]
    _conserves(lambda x: tm._block(params, x, "trunk_output.block2.block2-0", blk, tbase.TapCollector(())),
               _x(1, (2, 8, 8, 48), positive=True), rtol=1e-3)


def test_mnasnet_residual_block_conserves():
    tm, params = _model("MNASNet", variant="0_5")
    blk = tm.stacks[0][1]
    assert blk.residual
    _conserves(lambda x: tm._ir_block(params, x, "layers.8.1", blk, tbase.TapCollector(())),
               _x(4, (2, 8, 8, blk.c_in)), rtol=1e-3)


def test_efficientnet_v2_fused_block_conserves():
    tm, params = _model("EfficientNetV2", variant="v2_s")
    cfg = tm.stages[1][1]
    assert cfg.fused and cfg.residual
    _conserves(lambda x: tm._fused_mbconv(params, x, "features.2.1", cfg, tbase.TapCollector(())),
               _x(5, (2, 8, 8, cfg.c_in)), rtol=1e-3)


def test_convnext_block_conserves():
    """Depthwise conv, channels-last LayerNorm (detached denominator), GELU pass-through, layer scale and the
    residual split: biases zeroed, so the block conserves up to the LN's centring, which ε keeps."""
    tm, params = _model("ConvNeXt", variant="tiny")
    params = {k: torch.full_like(v, 0.5) if k.endswith("gamma") else v for k, v in params.items()}
    _conserves(lambda x: tm._block(lambda k: params[k], "stages.0.blocks.0", x, tbase.TapCollector(())),
               _x(6, (2, 8, 8, 96)), rtol=1e-3)


def test_mobilenet_v3_se_hardswish_block_conserves():
    tm, params = _model("MobileNetV3", variant="large")
    blk = tm.blocks[11]
    assert blk.use_se and blk.act == "HS" and blk.residual
    _conserves(lambda x: tm._bneck(params, x, "features.12", blk, tbase.TapCollector(())),
               _x(7, (2, 8, 8, blk.c_in)), rtol=1e-3)


def test_relu6_and_hardswish_hand_saturated_units_their_relevance():
    """A unit clipped at 6 keeps its relevance under a composite (the raw gradient mask would zero it)."""
    x = torch.tensor([[-1.0, 0.5, 7.0, 9.0]], requires_grad=True)
    for fn, jfn in ((tl.relu6, jl.relu6), (tl.hardswish, jl.hardswish)):
        with tl.lrp_composite("epsilon"):
            y = fn(x)
        (r,) = torch.autograd.grad(y, x, torch.ones_like(y))
        assert torch.equal(r, torch.ones_like(x))
        with jl.lrp_composite("epsilon"):
            jy, vjp = jax.vjp(jfn, jnp.asarray(x.detach().numpy()))
        np.testing.assert_array_equal(np.asarray(vjp(jnp.ones_like(jy))[0]), r.numpy())
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-6, atol=1e-7)
        with torch.no_grad():
            assert torch.equal(fn(x), fn(x.detach()))  # the plain forward outside a composite
