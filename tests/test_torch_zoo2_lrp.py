"""LRP through the blocks of the vision zoo's part two against the JAX package.

- One block per family under the ε and ε-plus-flat composites (flat first,
  or one rule consumed first so that convs take z⁺, as mid-network): the
  port's ``torch.autograd`` VJP against ``jax.vjp`` under the JAX composite
  (jitted), on the same numpy weights and inputs, float32 on the CPU. The
  blocks cover what part two adds to the rule stream: shifted-window
  attention with its float32 bias and −100 region mask (CP-LRP constants),
  Swin-V2's cosine attention, CPB bias and post-norm, MaxViT's window and
  grid attention (the axis swaps), ShuffleNet's split / concatenation /
  channel shuffle (both unit kinds), a Fire module and two Inception
  blocks (GoogLeNet's max-pool branch, Inception-v3's nested E
  concatenation).
- The conservation mirrors of the JAX package's (``tests/models/
  test_swin.py``, ``test_maxvit.py``, ``test_inception.py``,
  ``test_lrp_new_families.py``) on the port alone, at their bounds.
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


def _nhwc_fn(fn):
    """A port block that runs NCHW, seen as NHWC → NHWC."""
    return lambda x: fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _block_fns(case, jm, jp, tm, tp):
    """(JAX fn NHWC → NHWC, port fn NHWC → NHWC, input shape NHWC) of the case's block."""
    jt, tt = jbase.TapCollector(()), tbase.TapCollector(())
    tc = tbase.TapCollector((), channels_first=True)
    if case == "swin":  # shifted (shift 3 on a 14² map: two region cuts), pre-norm
        return (lambda x: jm._block(jp, x, "features.1.1", 3, 3, jt),
                lambda x: tm._block(tp, x, "features.1.1", 3, 3, tt), (2, 14, 14, 96))
    if case == "swin_v2":  # window 8, shift 4, padded 12² → 16²
        return (lambda x: jm._block(jp, x, "features.1.1", 3, 4, jt),
                lambda x: tm._block(tp, x, "features.1.1", 3, 4, tt), (1, 12, 12, 96))
    if case in ("maxvit_window", "maxvit_grid"):
        at, kind = f"blocks.1.layers.1.layers.{case[7:]}_attention", case[7:]
        return (lambda x: jm._partition_attention(jp, x, at, 4, kind, jt),
                lambda x: tm._partition_attention(tp, x, at, 4, kind, tt), (1, 14, 14, 128))
    if case in ("shufflenet_down", "shufflenet_split"):
        i = 0 if case.endswith("down") else 1
        unit, shape = jm.stages[1][i], ((2, 8, 8, 48) if i == 0 else (2, 4, 4, 96))
        return (lambda x: jm._unit(jp, x, f"stage3.{i}", unit, jt),
                _nhwc_fn(lambda x: tm._unit(tp, x, f"stage3.{i}", tm.stages[1][i], tc)), shape)
    if case == "fire":
        return (lambda x: jm._fire(jp, x, "features.4", jt), _nhwc_fn(lambda x: tm._fire(tp, x, "features.4", tc)),
                (2, 8, 8, 128))
    if case == "googlenet":
        return (lambda x: jm._inception(jp, x, "inception3a", jt),
                _nhwc_fn(lambda x: tm._inception(tp, x, "inception3a", tc)), (2, 8, 8, 192))
    return (lambda x: jm._mixed(jp, x, "Mixed_7b", "E", 1280, 0, jt),
            _nhwc_fn(lambda x: tm._mixed(tp, x, "Mixed_7b", "E", 1280, 0, tc)), (1, 4, 4, 1280))


CASES = {
    "swin": ("SwinTransformer", {}),
    "swin_v2": ("SwinTransformerV2", {}),
    "maxvit_window": ("MaxViT", {}),
    "maxvit_grid": ("MaxViT", {}),
    "shufflenet_down": ("ShuffleNetV2", {"variant": "x0_5"}),
    "shufflenet_split": ("ShuffleNetV2", {"variant": "x0_5"}),
    "fire": ("SqueezeNet", {"version": "1_1"}),
    "googlenet": ("GoogLeNet", {}),
    "inception_v3_e": ("InceptionV3", {}),
}

# Pre-norm attention blocks under flat-first: the flat rule hands the LayerNorm relevance that does not vanish
# where its output does, so the LN's ε rule divides by outputs near 0 at isolated tokens. The JAX package's own
# relevance moves by 7.4e-3 (max) / 2.1e-4 (mean) of its scale on the Swin block when the input moves by one ulp;
# the port's is 1.2e-3–4.9e-3 (max) from it, 0.2–0.7 % of the values beyond 1e-5 of the scale. These are held by
# their mean |Δ| over the mean |R| (measured ≤ 8.7e-5).
PRE_NORM = {"swin", "maxvit_window", "maxvit_grid"}
FLAT_LN_MEAN_REL = 2e-4


def _weights(tm):
    """The family's seed-0 draw with non-zero BN statistics and biases (so that the ε denominators see the
    shifts the rules must carry) and bias tables / CPB weights of a trained model's spread."""
    rng = np.random.default_rng(3)
    weights = tm.init_jax_layout(0)
    for name, shape, kind in tm._param_specs():
        if name.endswith(("running_mean", ".bias")):
            weights[name] = rng.normal(0, 0.1, shape).astype(np.float32)
        elif name.endswith("running_var"):
            weights[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif name.endswith("relative_position_bias_table"):
            weights[name] = rng.normal(0, 1.0, shape).astype(np.float32)
        elif ".cpb_mlp." in name:
            weights[name] = weights[name] + rng.normal(0, 0.2, shape).astype(np.float32)
    return weights


@pytest.fixture(scope="module", params=list(CASES))
def block(request):
    """(case, JAX block fn, port block fn, input shape NHWC) on one set of numpy weights."""
    cls, kw = CASES[request.param]
    jm = getattr(J, cls)(**kw, num_classes=0, dtype=jnp.float32)
    tm = getattr(T, cls)(**kw, num_classes=0, dtype=torch.float32, device="cpu")
    weights = _weights(tm)
    jp = {k: jnp.asarray(v) for k, v in weights.items()}
    return (request.param, *_block_fns(request.param, jm, jp, tm, tm.load_jax_params(weights)))


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("composite,skip", [("epsilon", 0), ("epsilon_plus_flat", 0), ("epsilon_plus_flat", 1)],
                         ids=["epsilon", "flat-first", "zplus"])
def test_block_relevance_matches_jax(block, composite, skip):
    """The same number of rule-bearing ops, the forward within 2e-5 of its scale, the input relevance within
    ``RELEVANCE_REL`` of its scale (measured ≤ 4.2e-5: ShuffleNet's z⁺, whose 1×1 convs see BN outputs).
    Block inputs are non-negative, as after a ReLU."""
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
    xt = torch.from_numpy(x).requires_grad_(True)
    with tl.lrp_composite(composite, epsilon=1e-6):
        for _ in range(skip):
            tl._next_rule("conv")
        tout = tfn(xt)
        seen["port"] = tl._LRP.n_linear_seen
    (trel,) = torch.autograd.grad(tout, xt, tout.detach())
    assert seen["port"] == seen["jax"] > skip
    assert _rel(tout.detach().numpy(), jout) <= 2e-5
    assert torch.isfinite(trel).all()
    if not skip and composite == "epsilon_plus_flat" and case in PRE_NORM:
        d = np.abs(trel.numpy() - np.asarray(jrel))
        assert d.mean() <= FLAT_LN_MEAN_REL * np.abs(np.asarray(jrel)).mean()
    else:
        assert _rel(trel.numpy(), jrel) <= RELEVANCE_REL


# ------------------------------------------------------------- conservation (port alone)
def _zeroed(tm, seed=0):
    params = tm.init(seed=seed)
    return {k: torch.zeros_like(v) if k.endswith((".bias", ".running_mean")) else v for k, v in params.items()}


def _conserves(fn, x, rtol):
    xx = x.clone().requires_grad_(True)
    with tl.lrp_composite("epsilon", epsilon=1e-9):
        out = fn(xx)
    (r_in,) = torch.autograd.grad(out, xx, out.detach())
    np.testing.assert_allclose(float(r_in.double().sum()), float(out.detach().double().sum()), rtol=rtol)
    return float(r_in.double().sum()), float(out.detach().double().sum())


def _x(seed, shape, positive=False):
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))
    return x.abs() if positive else x


def test_swin_block_conserves():
    """A shifted Swin block: detached LN, CP-LRP window attention, proportional residual splits (JAX
    ``test_lrp_conservation_through_swin_block``, rtol 5e-2)."""
    tm = T.SwinTransformer("tiny", num_classes=0, dtype=torch.float32, device="cpu")
    params = _zeroed(tm, 2)
    _conserves(lambda x: tm._block(params, x, "features.1.1", 3, 3, tbase.TapCollector(())), _x(3, (1, 14, 14, 96)),
               rtol=5e-2)


def test_swin_v2_block_conserves():
    """Swin-V2's post-norm block: CP-LRP cosine attention, LN after each branch (JAX rtol 5e-2)."""
    tm = T.SwinTransformerV2("tiny", num_classes=0, dtype=torch.float32, device="cpu")
    params = _zeroed(tm, 2)
    _conserves(lambda x: tm._block(params, x, "features.1.1", 3, 4, tbase.TapCollector(())), _x(6, (1, 16, 16, 96)),
               rtol=5e-2)


def test_maxvit_layer_conserves():
    """One MaxViT layer: MBConv with the SE constant gate, window and grid attention (JAX rtol 5e-2)."""
    tm = T.MaxViT("tiny", num_classes=0, partition_size=2, dtype=torch.float32, device="cpu")
    params = _zeroed(tm, 2)

    def layer(x):
        tap = tbase.TapCollector(())
        h = tm._mbconv(params, x.permute(0, 3, 1, 2), "blocks.1.layers.1.layers.MBconv", 128, 128, 1,
                       tbase.TapCollector((), channels_first=True)).permute(0, 2, 3, 1)
        h = tm._partition_attention(params, h, "blocks.1.layers.1.layers.window_attention", 4, "window", tap)
        return tm._partition_attention(params, h, "blocks.1.layers.1.layers.grid_attention", 4, "grid", tap)

    _conserves(layer, _x(3, (1, 8, 8, 128)), rtol=5e-2)


def test_shufflenet_units_conserve():
    """Split, concatenation and shuffle are exact partitions: both unit kinds conserve (JAX rtol 1e-3)."""
    tm = T.ShuffleNetV2("x0_5", num_classes=0, dtype=torch.float32, device="cpu")
    params = _zeroed(tm)
    tap = tbase.TapCollector((), channels_first=True)
    for i, shape, seed in ((0, (2, 48, 8, 8), 2), (1, (2, 96, 4, 4), 3)):
        _conserves(lambda x: tm._unit(params, x, f"stage3.{i}", tm.stages[1][i], tap), _x(seed, shape), rtol=1e-3)


def test_squeezenet_fire_conserves():
    tm = T.SqueezeNet("1_1", num_classes=0, dtype=torch.float32, device="cpu")
    params = _zeroed(tm)
    _conserves(lambda x: tm._fire(params, x, "features.4", tbase.TapCollector((), channels_first=True)),
               _x(7, (2, 128, 8, 8), positive=True), rtol=1e-3)


def test_inception_block_conserves():
    """GoogLeNet's four-branch block, the concatenation an exact split (JAX rtol 1e-2)."""
    tm = T.GoogLeNet(num_classes=0, dtype=torch.float32, device="cpu")
    params = _zeroed(tm, 4)
    _conserves(lambda x: tm._inception(params, x, "inception3a", tbase.TapCollector((), channels_first=True)),
               _x(5, (2, 192, 8, 8)), rtol=1e-2)


def test_channel_shuffle_is_the_jax_permutation():
    """The NCHW shuffle is the JAX package's NHWC one, value for value, and keeps channels_last memory."""
    from semanticlens_tpu.models.shufflenet import channel_shuffle as jshuffle
    from semanticlens_tpu_torch.models.shufflenet import channel_shuffle

    x = np.random.default_rng(0).normal(size=(2, 3, 5, 12)).astype(np.float32)
    want = np.asarray(jshuffle(jnp.asarray(x), 2))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    got = channel_shuffle(xt, 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
