"""Port parity: the LRP rules of ``models/layers.py`` against the JAX package.

Each rule runs on the same numpy inputs, weights and seed relevance in both
packages on the CPU in float32: the port's ``torch.autograd`` VJP under
``lrp_composite`` against ``jax.vjp`` under the JAX package's composite.
Layouts differ at the boundary only (the port's convs are NCHW/OIHW, the
JAX package's NHWC/HWIO). Tolerances are stated per test; the forward under
a composite must equal the plain forward.

The conservation tests mirror ``tests/collect/test_relevance_based.py``
(``:16`` and ``:365-447``) on the port alone.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semanticlens_tpu.models import layers as jl
from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch.models import layers as tl
from semanticlens_tpu_torch.models.resnet import ResNet as TResNet

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _jax_vjp(fn, inputs, seed, composite, skip=0, epsilon=1e-6):
    """(output, input relevances) of ``fn`` under the JAX composite; ``skip`` linear ops are consumed first."""
    with jl.lrp_composite(composite, epsilon=epsilon):
        for _ in range(skip):
            jl._next_rule("conv")
        out, vjp = jax.vjp(fn, *[jnp.asarray(i) for i in inputs])
        rel = vjp(jnp.asarray(seed))
    return np.asarray(out), [np.asarray(r) for r in rel]


def _torch_vjp(fn, inputs, seed, composite, skip=0, epsilon=1e-6):
    """The same through the port: autograd of ``fn`` under the port's composite."""
    xs = [i.detach().clone().requires_grad_(True) for i in inputs]
    with tl.lrp_composite(composite, epsilon=epsilon):
        for _ in range(skip):
            tl._next_rule("conv")
        out = fn(*xs)
    rel = torch.autograd.grad(out, xs, seed, allow_unused=True)
    return out.detach(), [torch.zeros_like(x) if r is None else r for x, r in zip(xs, rel)]


def test_rule_stream_matches_jax():
    """The same rule for each op of a stream, both composites; the counter resets on entry."""
    kinds = ["conv", "conv", "linear", "conv", "linear", "linear"]
    for comp in ("epsilon_plus_flat", "epsilon"):
        for _ in range(2):
            with jl.lrp_composite(comp, epsilon=1e-3), tl.lrp_composite(comp, epsilon=1e-3):
                assert [tl._next_rule(k) for k in kinds] == [jl._next_rule(k) for k in kinds]
    with tl.lrp_composite("gradient"):
        assert not tl._lrp_active()
    assert not tl._lrp_active()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stabiliser_is_bitwise_the_jax_formula(dtype):
    """``where(z ≥ 0, z + ε, z − ε)`` with ε in z's dtype equals ``z + ε·sign(z) + ε·[z = 0]`` as the
    JAX rules compute it, bit for bit: zeros, −0, values near ε and rounding boundaries included."""
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.normal(size=4000), rng.normal(size=4000) * 1e-6, rng.normal(size=4000) * 1e-3,
                           [0.0, -0.0, 1e-6, -1e-6, 2e-6, -5e-7, 3.0517578125e-05, 2.44140625e-4]])
    z_t = torch.from_numpy(vals.astype(np.float32)).to(getattr(torch, dtype))
    z_j = jnp.asarray(z_t.float().numpy()).astype(getattr(jnp, dtype))
    ref = z_j + 1e-6 * jnp.sign(z_j) + jnp.where(z_j == 0, 1e-6, 0.0)
    ours = tl._stabilised(z_t, 1e-6)
    assert ours.dtype == z_t.dtype
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)))


CONV_CASES = [  # (composite, linear ops consumed first, rule, stride, padding, bias)
    ("epsilon_plus_flat", 0, "flat", 1, 1, True),
    ("epsilon_plus_flat", 1, "zplus", 2, 1, False),
    ("epsilon_plus_flat", 1, "zplus", 1, 0, True),
    ("epsilon", 0, "epsilon", 1, 1, True),
    ("epsilon", 0, "epsilon", 2, 0, False),
]


@pytest.mark.parametrize("composite,skip,rule,stride,padding,bias", CONV_CASES)
def test_conv_rules_match_jax(composite, skip, rule, stride, padding, bias):
    """conv2d under flat, z⁺ and ε: forward atol 1e-5, relevance atol 1e-5 + rtol 1e-4 (float32)."""
    rng = np.random.default_rng(stride * 10 + padding + skip)
    x = rng.normal(size=(2, 9, 9, 4)).astype(np.float32)
    w = rng.normal(size=(3, 3, 4, 6)).astype(np.float32) * 0.4
    b = rng.normal(size=(6,)).astype(np.float32) * 0.2 if bias else None
    ho = (9 + 2 * padding - 3) // stride + 1
    seed = rng.normal(size=(2, ho, ho, 6)).astype(np.float32)

    def jfn(xx):
        return jl.conv2d(xx, jnp.asarray(w), None if b is None else jnp.asarray(b), stride=stride, padding=padding)

    w_t = _t(w.transpose(3, 2, 0, 1))
    b_t = None if b is None else _t(b)

    def tfn(xx):
        return tl.conv2d(xx, w_t, b_t, stride=stride, padding=padding)

    with tl.lrp_composite(composite):
        for _ in range(skip):
            tl._next_rule("conv")
        assert tl._next_rule("conv")[0] == rule
    jout, (jrel,) = _jax_vjp(jfn, [x], seed, composite, skip)
    tout, (trel,) = _torch_vjp(tfn, [_nchw(x)], _nchw(seed), composite, skip)
    np.testing.assert_allclose(_nhwc(tout), jout, atol=1e-5)
    np.testing.assert_allclose(_nhwc(tout), _nhwc(tfn(_nchw(x))), atol=0)  # forward unchanged
    np.testing.assert_allclose(_nhwc(trel), jrel, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("composite,skip", [("epsilon_plus_flat", 0), ("epsilon_plus_flat", 1), ("epsilon", 0)])
def test_linear_rules_match_jax(composite, skip):
    """linear under flat and ε (z⁺ is conv-only): atol 1e-5 + rtol 1e-4."""
    rng = np.random.default_rng(7 + skip)
    x = rng.normal(size=(3, 5, 8)).astype(np.float32)
    w = rng.normal(size=(8, 6)).astype(np.float32) * 0.5
    b = rng.normal(size=(6,)).astype(np.float32) * 0.1
    seed = rng.normal(size=(3, 5, 6)).astype(np.float32)
    jout, (jrel,) = _jax_vjp(lambda xx: jl.linear(xx, jnp.asarray(w), jnp.asarray(b)), [x], seed, composite, skip)
    w_t, b_t = _t(w.T), _t(b)
    tout, (trel,) = _torch_vjp(lambda xx: tl.linear(xx, w_t, b_t), [_t(x)], _t(seed), composite, skip)
    np.testing.assert_allclose(tout.numpy(), jout, atol=1e-5)
    np.testing.assert_allclose(trel.numpy(), jrel, atol=1e-5, rtol=1e-4)


def test_batch_norm_rule_matches_jax_and_keeps_the_forward():
    """BN under a composite is the JAX form x·scale + shift with the ε rule: forward atol 1e-5
    against the fused ``F.batch_norm`` outside it, relevance atol 1e-5 + rtol 1e-4 against JAX."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 5, 6)).astype(np.float32)
    p = [rng.uniform(0.5, 1.5, 6), rng.normal(size=6) * 0.2, rng.normal(size=6) * 0.2, rng.uniform(0.5, 1.5, 6)]
    p = [a.astype(np.float32) for a in p]
    seed = rng.normal(size=x.shape).astype(np.float32)
    jout, (jrel,) = _jax_vjp(lambda xx: jl.batch_norm(xx, *[jnp.asarray(a) for a in p]), [x], seed, "epsilon")
    tp = [_t(a) for a in p]
    tout, (trel,) = _torch_vjp(lambda xx: tl.batch_norm(xx, *tp), [_nchw(x)], _nchw(seed), "epsilon")
    np.testing.assert_allclose(_nhwc(tout), jout, atol=1e-5)
    np.testing.assert_allclose(_nhwc(tout), _nhwc(tl.batch_norm(_nchw(x), *tp)), atol=1e-5)
    np.testing.assert_allclose(_nhwc(trel), jrel, atol=1e-5, rtol=1e-4)


def test_residual_split_matches_jax():
    """Proportional split, both branches: rtol 1e-5; outside a composite a plain add."""
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(2, 3, 4, 4)).astype(np.float32), rng.normal(size=(2, 3, 4, 4)).astype(np.float32)
    seed = rng.normal(size=a.shape).astype(np.float32)
    jout, jrel = _jax_vjp(jl.residual_add, [a, b], seed, "epsilon", epsilon=1e-9)
    tout, trel = _torch_vjp(tl.residual_add, [_t(a), _t(b)], _t(seed), "epsilon", epsilon=1e-9)
    np.testing.assert_array_equal(tout.numpy(), jout)
    for ours, ref in zip(trel, jrel):
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(tl.residual_add(_t(a), _t(b)), _t(a) + _t(b))


def test_layer_norm_gelu_and_quick_gelu_rules_match_jax():
    """Detached-denominator LN (atol 1e-5 + rtol 1e-4) and the pass-through activations (exact)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 9, 16)).astype(np.float32)
    wgt, bias = rng.uniform(0.5, 1.5, 16).astype(np.float32), rng.normal(size=16).astype(np.float32) * 0.1
    seed = rng.normal(size=x.shape).astype(np.float32)
    jout, (jrel,) = _jax_vjp(lambda xx: jl.layer_norm(xx, jnp.asarray(wgt), jnp.asarray(bias)), [x], seed, "epsilon")
    tout, (trel,) = _torch_vjp(lambda xx: tl.layer_norm(xx, _t(wgt), _t(bias)), [_t(x)], _t(seed), "epsilon")
    np.testing.assert_allclose(tout.numpy(), jout, atol=1e-5)
    np.testing.assert_allclose(tout.numpy(), tl.layer_norm(_t(x), _t(wgt), _t(bias)).numpy(), atol=1e-6)
    np.testing.assert_allclose(trel.numpy(), jrel, atol=1e-5, rtol=1e-4)
    for jfn, tfn in ((lambda xx: jl.gelu(xx), lambda xx: tl.gelu(xx)),
                     (lambda xx: jl.gelu(xx, approximate=True), lambda xx: tl.gelu(xx, approximate=True)),
                     (jl.quick_gelu, tl.quick_gelu)):
        jout, (jrel,) = _jax_vjp(jfn, [x], seed, "epsilon_plus_flat")
        tout, (trel,) = _torch_vjp(tfn, [_t(x)], _t(seed), "epsilon_plus_flat")
        np.testing.assert_allclose(tout.numpy(), jout, atol=1e-6)
        np.testing.assert_array_equal(trel.numpy(), seed)
        np.testing.assert_array_equal(jrel, seed)


def test_cp_lrp_attention_and_mha_match_jax():
    """CP-LRP: q/k get no relevance, v all of it (atol 1e-5 + rtol 1e-4 against JAX); the MHA
    under a composite runs three in-projections, each with its rule, and matches JAX end to end
    within 1e-4 of the largest relevance."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(2, 5, 16)).astype(np.float32) for _ in range(3))
    seed = rng.normal(size=(2, 5, 16)).astype(np.float32)
    mask = np.triu(np.full((5, 5), -np.inf, np.float32), k=1)
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else _t(m)
        jout, jrel = _jax_vjp(lambda a, b, c: jl.scaled_dot_product_attention(a, b, c, 2, mask=jm),
                              [q, k, v], seed, "epsilon")
        tout, trel = _torch_vjp(lambda a, b, c: tl.scaled_dot_product_attention(a, b, c, 2, mask=tm),
                                [_t(q), _t(k), _t(v)], _t(seed), "epsilon")
        np.testing.assert_allclose(tout.numpy(), jout, atol=1e-5)
        np.testing.assert_allclose(
            tout.numpy(), tl.scaled_dot_product_attention(_t(q), _t(k), _t(v), 2, mask=tm).numpy(), atol=1e-5)
        assert float(trel[0].abs().max()) == 0.0 and float(trel[1].abs().max()) == 0.0
        np.testing.assert_allclose(trel[2].numpy(), jrel[2], atol=1e-5, rtol=1e-4)

    d = 16
    jp = {"a.in_proj_weight": rng.normal(size=(d, 3 * d)).astype(np.float32) * 0.3,
          "a.in_proj_bias": rng.normal(size=3 * d).astype(np.float32) * 0.1,
          "a.out_proj.weight": rng.normal(size=(d, d)).astype(np.float32) * 0.3,
          "a.out_proj.bias": rng.normal(size=d).astype(np.float32) * 0.1}
    tp = convert.clip_params_from_jax(jp)
    jparams = {key: jnp.asarray(val) for key, val in jp.items()}
    with tl.lrp_composite("epsilon"):
        tl.multi_head_attention(_t(q), tp, "a", 2)
        assert tl._LRP.n_linear_seen == 4  # q, k, v and the out-projection
    for comp in ("epsilon_plus_flat", "epsilon"):
        jout, (jrel,) = _jax_vjp(lambda xx: jl.multi_head_attention(xx, jparams, "a", 2), [q], seed, comp, skip=1)
        tout, (trel,) = _torch_vjp(lambda xx: tl.multi_head_attention(xx, tp, "a", 2), [_t(q)], _t(seed), comp, skip=1)
        np.testing.assert_allclose(tout.numpy(), jout, atol=1e-5)
        # Four stacked ε rules amplify last-bit differences where a denominator is near 0.
        np.testing.assert_allclose(trel.numpy(), jrel, atol=1e-4 * np.abs(jrel).max())


# --------------------------------------------------------------------------- #
# Conservation, on the port alone (mirrors of the JAX package's tests)
# --------------------------------------------------------------------------- #
def _conservation(fn, x, composite="epsilon"):
    """(Σ R_in, Σ R_out) with R_out seeded as the output itself."""
    xx = x.clone().requires_grad_(True)
    with tl.lrp_composite(composite, epsilon=1e-9):
        out = fn(xx)
    (r_in,) = torch.autograd.grad(out, xx, out.detach())
    return float(r_in.double().sum()), float(out.detach().double().sum()), r_in


def test_lrp_epsilon_conserves_relevance_linear_net():
    rng = np.random.default_rng(0)
    w1 = _t(rng.normal(size=(8, 16)).astype(np.float32).T)
    w2 = _t(rng.normal(size=(16, 4)).astype(np.float32).T)
    x = _t(rng.normal(size=(1, 8)).astype(np.float32)).requires_grad_(True)
    with tl.lrp_composite("epsilon", epsilon=1e-9):
        out = tl.linear(torch.relu(tl.linear(x, w1)), w2)[0, 2]
    (rel,) = torch.autograd.grad(out, x)
    np.testing.assert_allclose(float(rel.sum()), 1.0, rtol=1e-3)


def _vit_block_params(w):
    rng = np.random.default_rng(2)
    mats = {"qkv": (w, 3 * w), "proj": (w, w), "fc1": (w, 4 * w), "fc2": (4 * w, w)}
    p = {f"{n}.weight": _t((rng.normal(size=s) * s[0] ** -0.5).astype(np.float32).T) for n, s in mats.items()}
    p.update({f"{n}.bias": torch.zeros(s[1]) for n, s in mats.items()})
    for i, n in enumerate(("norm1", "norm2")):
        p[f"{n}.weight"] = _t(np.random.default_rng(i).uniform(0.5, 1.5, w).astype(np.float32))
        p[f"{n}.bias"] = torch.zeros(w)
    return p


def _vit_block_apply(p, x, heads=2):
    w = x.shape[-1]
    h = tl.layer_norm(x, p["norm1.weight"], p["norm1.bias"])
    qkv = tl.linear(h, p["qkv.weight"], p["qkv.bias"])
    h = tl.scaled_dot_product_attention(qkv[..., :w], qkv[..., w : 2 * w], qkv[..., 2 * w :], heads)
    x = tl.residual_add(x, tl.linear(h, p["proj.weight"], p["proj.bias"]))
    h = tl.linear(tl.layer_norm(x, p["norm2.weight"], p["norm2.bias"]), p["fc1.weight"], p["fc1.bias"])
    return tl.residual_add(x, tl.linear(tl.gelu(h), p["fc2.weight"], p["fc2.bias"]))


def test_lrp_conserves_through_full_vit_block():
    """ε composite: a whole pre-LN block conserves relevance (rtol 1e-3), and differs from the gradient."""
    x = _t(np.random.default_rng(5).normal(size=(2, 17, 32)).astype(np.float32))
    p = _vit_block_params(32)
    r_in, r_out, r_map = _conservation(lambda xx: _vit_block_apply(p, xx), x)
    np.testing.assert_allclose(r_in, r_out, rtol=1e-3)
    _, _, g_map = _conservation(lambda xx: _vit_block_apply(p, xx), x, composite="gradient")
    diff = float((r_map - g_map).abs().sum() / r_map.abs().sum())
    assert diff > 0.2, f"gradient and LRP relevance unexpectedly agree ({diff:.3f})"


def test_lrp_conserves_through_bottleneck_block():
    """ε composite, bias-free convs and BN without shift: one ResNet-50 bottleneck
    (the downsampling one, with its projection shortcut) conserves relevance, rtol 1e-3."""
    model = TResNet(depth=50, num_classes=4, dtype=torch.float32, device="cpu")
    params = model.init(seed=0)
    rng = np.random.default_rng(1)
    for name in params:
        if "running_var" in name or name.endswith("bn1.weight") or ".bn" in name and name.endswith("weight"):
            params[name] = _t(rng.uniform(0.5, 1.5, params[name].shape).astype(np.float32))
    x = _t(np.abs(rng.normal(size=(2, 256, 8, 8))).astype(np.float32)).contiguous(memory_format=torch.channels_last)

    def block(xx):
        return model._bottleneck_block(params, "layer2.0", xx, 2, lambda _, v: v)

    r_in, r_out, _ = _conservation(block, x)
    np.testing.assert_allclose(r_in, r_out, rtol=1e-3)


def test_cp_lrp_value_path_conserves_and_gelu_passes_unchanged():
    rng = np.random.default_rng(8)
    q, k, v = (_t(rng.normal(size=(2, 5, 16)).astype(np.float32)) for _ in range(3))
    r_in, r_out, _ = _conservation(lambda vv: tl.scaled_dot_product_attention(q, k, vv, 2), v)
    np.testing.assert_allclose(r_in, r_out, rtol=1e-4)
    wgt = _t(np.random.default_rng(7).uniform(0.5, 1.5, 16).astype(np.float32))
    r_in, r_out, _ = _conservation(lambda xx: tl.layer_norm(xx, wgt, torch.zeros(16)), q)
    np.testing.assert_allclose(r_in, r_out, rtol=1e-4)


# --------------------------------------------------------------------------- #
# Outside a composite the forward is the plain one, bit for bit
# --------------------------------------------------------------------------- #
def _plain_resnet(model, params, x, names):
    """The ResNet forward written out with torch.nn.functional, as the port ran it before LRP."""
    import torch.nn.functional as F

    taps = {}

    def tap(name, value):
        if name in names:
            taps[name] = value
        return value

    def bn(prefix, h):
        return F.batch_norm(h, params[f"{prefix}.running_mean"].float(), params[f"{prefix}.running_var"].float(),
                            params[f"{prefix}.weight"].float(), params[f"{prefix}.bias"].float(),
                            training=False, eps=1e-5)

    def conv(name, h, stride=1, padding=0):
        return F.conv2d(h, params[f"{name}.weight"].to(h.dtype), None, stride=stride, padding=padding)

    h = x.permute(0, 3, 1, 2).to(model.dtype)
    h = tap("relu", torch.relu(tap("bn1", bn("bn1", tap("conv1", conv("conv1", h, 2, 3))))))
    h = tap("maxpool", F.max_pool2d(h, 3, 2, 1))
    for stage, n_blocks in enumerate(model.stage_blocks, start=1):
        for b in range(n_blocks):
            p, stride = f"layer{stage}.{b}", 2 if (stage > 1 and b == 0) else 1
            out = torch.relu(tap(f"{p}.bn1", bn(f"{p}.bn1", tap(f"{p}.conv1", conv(f"{p}.conv1", h)))))
            out = torch.relu(tap(f"{p}.bn2", bn(f"{p}.bn2", tap(f"{p}.conv2", conv(f"{p}.conv2", out, stride, 1)))))
            out = tap(f"{p}.bn3", bn(f"{p}.bn3", tap(f"{p}.conv3", conv(f"{p}.conv3", out))))
            identity = h
            if f"{p}.downsample.0.weight" in params:
                identity = bn(f"{p}.downsample.1", conv(f"{p}.downsample.0", h, stride))
            h = tap(p, tap(f"{p}.relu", torch.relu(out + identity)))
        h = tap(f"layer{stage}", h)
    logits = F.linear(torch.mean(h, dim=(2, 3)), params["fc.weight"].to(h.dtype), params["fc.bias"].to(h.dtype))
    return logits, {k: v.permute(0, 2, 3, 1) for k, v in taps.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quickstart_resnet50_forward_is_bitwise_the_plain_one(dtype):
    """The quickstart's ResNet-50 (layer3, layer4 and every block's taps), outside a composite:
    logits and taps bitwise equal to the plain functional forward."""
    model = TResNet(depth=50, num_classes=10, dtype=dtype, device="cpu")
    params = model.init(seed=0)
    x = _t(np.random.default_rng(0).random((2, 32, 32, 3)).astype(np.float32))
    names = ("layer3", "layer4", "layer3.0", "layer3.0.bn3", "layer4.2.relu", "relu", "maxpool")
    logits, taps = model.apply(params, x, names)
    ref_logits, ref_taps = _plain_resnet(model, params, x, names)
    assert torch.equal(logits, ref_logits)
    for name in names:
        assert torch.equal(taps[name], ref_taps[name]), name


def test_forward_under_composite_equals_plain_forward():
    """ResNet-18 taps under each composite: atol 1e-5 of the plain forward (BN's two forms differ
    in the last bits only)."""
    model = TResNet(depth=18, num_classes=10, dtype=torch.float32, device="cpu")
    params = model.init(seed=1)
    x = _t(np.random.default_rng(1).random((2, 32, 32, 3)).astype(np.float32))
    names = ("layer2", "layer3", "layer4")
    logits, taps = model.apply(params, x, names)
    for comp in ("epsilon_plus_flat", "epsilon", "gradient"):
        with tl.lrp_composite(comp):
            lg, tp = model.apply(params, x, names)
        np.testing.assert_allclose(lg.detach().numpy(), logits.numpy(), atol=1e-5)
        for name in names:
            np.testing.assert_allclose(tp[name].detach().numpy(), taps[name].numpy(), atol=1e-5)
