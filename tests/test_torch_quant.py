"""Port parity: ``ops/quant.py`` and the int8 paths of ``models/layers.py`` against the JAX package.

The same numpy inputs and weights go through the JAX module
(``semanticlens_tpu.ops.quant``, XLA on the CPU) and the port. Layouts
differ at the boundary only: the JAX package keeps dense weights (in, out),
conv weights HWIO and activations NHWC; the port (out, in), OIHW and NCHW.
Integers (``q``, ``x_q``, the int32 accumulators) must be equal exactly;
scales exactly; float outputs within 1e-6 relative in float32 and one bf16
step in bfloat16, as stated per test. The JAX module keeps ``x_q`` and the
accumulator internal, so the JAX side here recomputes them with its lines
(``ops/quant.py:106-111`` and ``:130-139``) on jnp arrays.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semanticlens_tpu.models import layers as jl
from semanticlens_tpu.ops import quant as jq
from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch.models import layers as tl
from semanticlens_tpu_torch.ops import quant as tq

torch.set_num_threads(2)

BF16_STEP = 2.0**-7  # one bfloat16 step, relative


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _port_qt(jqt) -> tq.QuantizedTensor:
    return convert.quantized_from_jax(jqt)


def _jax_rows(x):
    """``x_q`` and ``x_scale`` of JAX ``int8_matmul`` (its lines 106-109)."""
    x32 = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(x32), axis=-1, keepdims=True)
    x_scale = jnp.where(absmax > 0, absmax / 127.0, 1.0)
    return jnp.clip(jnp.round(x32 / x_scale), -127, 127).astype(jnp.int8), x_scale


def _jax_samples(x):
    """``x_q`` of JAX ``int8_conv`` (its lines 130-133), NHWC."""
    x32 = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(x32), axis=(1, 2, 3), keepdims=True)
    x_scale = jnp.where(absmax > 0, absmax / 127.0, 1.0)
    return jnp.clip(jnp.round(x32 / x_scale), -127, 127).astype(jnp.int8)


# --------------------------------------------------------------------------- weights
@pytest.mark.parametrize("shape", [(48, 40), (3, 3, 16, 24), (1, 1, 8, 12)], ids=["dense", "conv3x3", "conv1x1"])
def test_quantize_weight_equals_jax_after_the_layout_transpose(shape):
    """``q`` and ``scale`` exactly equal to the JAX ones (a zero out channel included: scale 1, q 0)."""
    w = _rand(shape, 0, 0.3)
    w[..., 5] = 0.0
    w[..., 6] *= 1e-30  # a tiny but non-zero channel
    jqt = jq.quantize_weight(jnp.asarray(w))
    w_port = w.T if w.ndim == 2 else w.transpose(3, 2, 0, 1)
    tqt = tq.quantize_weight(_t(w_port))
    ref = _port_qt(jqt)
    assert tqt.q.dtype == torch.int8 and tqt.scale.dtype == torch.float32 and tqt.q.is_contiguous()
    assert tqt.out_features == shape[-1] and tqt.scale.shape == (shape[-1],)
    assert torch.equal(tqt.q, ref.q) and torch.equal(tqt.scale, ref.scale)
    assert float(tqt.scale[5]) == 1.0 and not tqt.q[5].any()
    np.testing.assert_array_equal(tq.dequantize(tqt).numpy(),
                                  np.asarray(jq.dequantize(jqt)).T if w.ndim == 2
                                  else np.asarray(jq.dequantize(jqt)).transpose(3, 2, 0, 1))


def test_quantize_weight_is_the_same_from_a_channels_last_weight():
    w = _t(_rand((24, 16, 3, 3), 1))
    a = tq.quantize_weight(w)
    b = tq.quantize_weight(w.contiguous(memory_format=torch.channels_last))
    assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale) and b.q.is_contiguous()


def test_col_slice_slices_the_out_axis_as_jax_slices_columns():
    w = _rand((16, 48), 2)
    jqt = jq.quantize_weight(jnp.asarray(w))
    tqt = tq.quantize_weight(_t(w.T))
    for start, stop in ((0, 16), (16, 32), (32, 48), (5, 9)):
        got, want = tq.col_slice(tqt, start, stop), _port_qt(jq.col_slice(jqt, start, stop))
        assert torch.equal(got.q, want.q) and torch.equal(got.scale, want.scale)
        # per-out-channel scales make the slice equal to quantizing the slice
        direct = tq.quantize_weight(_t(w.T[start:stop]))
        assert torch.equal(got.q, direct.q) and torch.equal(got.scale, direct.scale)
    plain = _t(w.T)
    assert torch.equal(tq.col_slice(plain, 3, 7), plain[3:7])


def test_quantized_tensor_moves_and_keeps_its_dtypes():
    qt = tq.quantize_weight(_t(_rand((8, 4), 3)))
    moved = qt.to("cpu")
    assert isinstance(moved, tq.QuantizedTensor) and moved.q.dtype == torch.int8
    assert moved.scale.dtype == torch.float32 and moved.shape == (8, 4) and moved.in_features == 4


# --------------------------------------------------------------------------- int8_matmul
@pytest.mark.parametrize("rows", [1, 5, 17, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_equals_jax(rows, dtype):
    """x_q and the int32 accumulator exactly; the output within 1e-6 relative (float32) or one bf16 step."""
    k, n = 40, 24
    x = _rand((rows, k), 10 + rows)
    w = _rand((k, n), 11)
    x[0] = 0.0  # a zero row: scale 1, exactly zero out
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = _t(x).to(getattr(torch, dtype))
    jqt = jq.quantize_weight(jnp.asarray(w))
    tqt = _port_qt(jqt)

    jx_q, _ = _jax_rows(jx)
    tx_q, _ = tq.quantize_rows(tx)
    np.testing.assert_array_equal(tx_q.numpy(), np.asarray(jx_q))
    jacc = jax.lax.dot_general(jx_q, jqt.q, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    tacc = tq.int_mm(tx_q, tqt.q)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))

    jout = np.asarray(jq.int8_matmul(jx, jqt).astype(jnp.float32))
    tout = tq.int8_matmul(tx, tqt)
    assert tout.dtype == tx.dtype and tout.shape == (rows, n)
    tout = tout.float().numpy()
    assert not tout[0].any()
    rel = 1e-6 if dtype == "float32" else BF16_STEP
    np.testing.assert_allclose(tout, jout, rtol=rel, atol=rel * np.abs(jout).max())


def test_int8_matmul_keeps_leading_axes():
    x = _rand((2, 7, 16), 12)
    w = _rand((16, 8), 13)
    jqt = jq.quantize_weight(jnp.asarray(w))
    out = tq.int8_matmul(_t(x), _port_qt(jqt))
    assert out.shape == (2, 7, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(jq.int8_matmul(jnp.asarray(x), jqt)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m,k,n", [(1, 36, 4), (5, 40, 8), (16, 8, 8), (17, 64, 16), (3, 7, 5)])
def test_int_mm_padding_gives_the_unpadded_product(m, k, n):
    """Rows, K and N padded to ``_int_mm``'s CUDA rules (> 16 rows, K and N multiples of 8) and cut off."""
    g = torch.Generator().manual_seed(m * 100 + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    out = tq.int_mm(a, w)
    assert out.shape == (m, n) and out.dtype == torch.int32
    assert torch.equal(out, a.int() @ w.int().t())


# --------------------------------------------------------------------------- int8_conv
CONV_CASES = {  # id: (cin, cout, k, stride, padding, groups)
    "1x1_s1": (16, 24, 1, 1, 0, 1),
    "3x3_s1_p1": (8, 16, 3, 1, 1, 1),
    "3x3_s2_p1": (8, 16, 3, 2, 1, 1),
    "1x1_s2_downsample": (16, 32, 1, 2, 0, 1),
    "3x3_groups32_4ch": (128, 128, 3, 1, 1, 32),
    "3x3_s2_groups32_4ch": (128, 128, 3, 2, 1, 32),
}


@pytest.mark.parametrize("case", list(CONV_CASES), ids=list(CONV_CASES))
@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
def test_int8_conv_equals_jax(case, channels_last):
    """x_q and the int32 accumulator exactly (the im2col's (C, kh, kw) order is q's); output within 1e-6."""
    cin, cout, k, stride, padding, groups = CONV_CASES[case]
    x = _rand((2, 9, 9, cin), 20)
    w = _rand((k, k, cin // groups, cout), 21, 0.2)
    jqt = jq.quantize_weight(jnp.asarray(w))
    tqt = _port_qt(jqt)
    tx = _t(x).permute(0, 3, 1, 2)
    if channels_last:
        tx = tx.contiguous(memory_format=torch.channels_last)
    jx_q = _jax_samples(jnp.asarray(x))
    tx_q, _ = tq.quantize_samples(tx)
    np.testing.assert_array_equal(tx_q.permute(0, 2, 3, 1).numpy(), np.asarray(jx_q))
    pad = ((padding, padding), (padding, padding))
    jacc = jax.lax.conv_general_dilated(jx_q, jqt.q, (stride, stride), pad, dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        feature_group_count=groups, preferred_element_type=jnp.int32)
    tacc = tq.int8_conv_acc(tx_q, tqt.q, stride=stride, padding=padding, groups=groups)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    jout = np.asarray(jq.int8_conv(jnp.asarray(x), jqt, stride=(stride, stride), padding=pad, groups=groups))
    tout = tq.int8_conv(tx, tqt, stride=stride, padding=padding, groups=groups)
    assert tout.is_contiguous(memory_format=torch.channels_last) and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.permute(0, 2, 3, 1).numpy(), jout, rtol=1e-6, atol=1e-6 * np.abs(jout).max())


def test_int8_conv_zero_input_is_exactly_zero():
    qt = tq.quantize_weight(_t(_rand((8, 4, 3, 3), 22)))
    out = tq.int8_conv(torch.zeros(2, 4, 5, 5), qt, padding=1)
    assert out.shape == (2, 8, 5, 5) and not out.any()


def test_int8_conv_bf16_within_one_step_of_jax():
    x = _rand((2, 8, 8, 16), 23)
    w = _rand((3, 3, 16, 16), 24, 0.2)
    jqt = jq.quantize_weight(jnp.asarray(w))
    jout = np.asarray(jq.int8_conv(jnp.asarray(x).astype(jnp.bfloat16), jqt, padding=((1, 1), (1, 1)))
                      .astype(jnp.float32))
    tout = tq.int8_conv(_t(x).permute(0, 3, 1, 2).to(torch.bfloat16), _port_qt(jqt), padding=1)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(tout.float().permute(0, 2, 3, 1).numpy(), jout, rtol=BF16_STEP,
                               atol=BF16_STEP * np.abs(jout).max())


# --------------------------------------------------------------------------- quantize_params
def test_quantize_params_predicate_and_rank_guard():
    """As the JAX test: matched rank-2/4 weights quantized, the rest untouched; a matched rank-1 raises."""
    params = {"a.weight": _t(_rand((8, 4), 30)), "a.bias": _t(_rand((8,), 31)),
              "c.weight": _t(_rand((6, 4, 3, 3), 32)), "b.weight": _t(_rand((5, 5), 33))}
    out = tq.quantize_params(params, lambda k: k in ("a.weight", "c.weight"))
    assert isinstance(out["a.weight"], tq.QuantizedTensor) and isinstance(out["c.weight"], tq.QuantizedTensor)
    assert out["a.bias"] is params["a.bias"] and out["b.weight"] is params["b.weight"]
    again = tq.quantize_params(out, lambda k: True if k != "a.bias" else False)
    assert again["a.weight"] is out["a.weight"]  # already quantized: left as it is
    jout = jq.quantize_params({k: jnp.asarray(v.numpy().transpose(2, 3, 1, 0) if v.ndim == 4 else v.numpy().T)
                               for k, v in params.items()}, lambda k: k in ("a.weight", "c.weight"))
    for key in ("a.weight", "c.weight"):
        assert torch.equal(out[key].q, _port_qt(jout[key]).q)
    with pytest.raises(ValueError, match="rank 1"):
        tq.quantize_params(params, lambda k: k == "a.bias")
    with pytest.raises(ValueError, match="rank 1"):
        jq.quantize_params({"a.bias": jnp.zeros(8)}, lambda k: True)
    match = tq.transformer_dense_match("visual.transformer.")
    assert tq.TRANSFORMER_DENSE_SUFFIXES == jq.TRANSFORMER_DENSE_SUFFIXES
    for key in ("visual.transformer.resblocks.0.attn.in_proj_weight", "visual.transformer.resblocks.3.mlp.c_fc.weight",
                "transformer.resblocks.0.mlp.c_proj.weight", "visual.transformer.resblocks.0.ln_1.weight"):
        assert match(key) == jq.transformer_dense_match("visual.transformer.")(key)


# --------------------------------------------------------------------------- layers
def test_linear_with_a_quantized_weight_equals_jax():
    x = _rand((3, 5, 16), 40)
    w, b = _rand((16, 24), 41), _rand((24,), 42)
    jqt = jq.quantize_weight(jnp.asarray(w))
    jout = np.asarray(jl.linear(jnp.asarray(x), jqt, jnp.asarray(b)))
    tout = tl.linear(_t(x), _port_qt(jqt), _t(b)).numpy()
    np.testing.assert_allclose(tout, jout, rtol=1e-6, atol=1e-6 * np.abs(jout).max())


@pytest.mark.parametrize("stride,padding,groups", [(1, 1, 1), (2, 1, 1), (2, 0, 1), (1, 1, 4)])
def test_conv2d_with_a_quantized_weight_equals_jax(stride, padding, groups):
    x = _rand((2, 10, 10, 8), 43)
    w, b = _rand((3, 3, 8 // groups, 12), 44, 0.3), _rand((12,), 45)
    jqt = jq.quantize_weight(jnp.asarray(w))
    jout = np.asarray(jl.conv2d(jnp.asarray(x), jqt, jnp.asarray(b), stride=stride, padding=padding, groups=groups))
    tout = tl.conv2d(_t(x).permute(0, 3, 1, 2), _port_qt(jqt), _t(b), stride=stride, padding=padding,
                     groups=groups)
    np.testing.assert_allclose(tout.permute(0, 2, 3, 1).numpy(), jout, rtol=1e-6, atol=1e-6 * np.abs(jout).max())


def _mha_params(d, seed):
    rng = np.random.default_rng(seed)
    return {"attn.in_proj_weight": (rng.standard_normal((d, 3 * d)) * d**-0.5).astype(np.float32),
            "attn.in_proj_bias": (rng.standard_normal(3 * d) * 0.1).astype(np.float32),
            "attn.out_proj.weight": (rng.standard_normal((d, d)) * d**-0.5).astype(np.float32),
            "attn.out_proj.bias": (rng.standard_normal(d) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("path", ["fused_self_attention", "split_cross_attention"])
def test_multi_head_attention_with_a_quantized_in_proj_equals_jax(path):
    """The fused (one in-proj product, then a split) and split (``col_slice``) paths, int8 in- and out-proj.

    Bound 1e-5 of the output's scale: the attention core's float32 sums may differ in the last bit
    between the packages, which can move one rounding of the out-proj's per-row quantization (the
    gap measured here: 1.9e-7 on the fused path, 1.6e-7 on the split one; int8_matmul alone: 0)."""
    d, heads = 32, 4
    p = _mha_params(d, 50)
    x = _rand((2, 6, d), 51)
    kv = _rand((2, 9, d), 52) if path.startswith("split") else None
    jp = jq.quantize_params({k: jnp.asarray(v) for k, v in p.items()}, lambda k: k.endswith("weight"))
    tp = convert.clip_params_from_jax(jp)
    assert isinstance(tp["attn.in_proj_weight"], tq.QuantizedTensor)
    jout = np.asarray(jl.multi_head_attention(jnp.asarray(x), jp, "attn", heads,
                                              kv=None if kv is None else jnp.asarray(kv)))
    tout = tl.multi_head_attention(_t(x), tp, "attn", heads, kv=None if kv is None else _t(kv)).numpy()
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-5 * np.abs(jout).max())


def _torch_relevance(fn, x, seed, composite):
    xx = x.detach().clone().requires_grad_(True)
    with tl.lrp_composite(composite):
        out = fn(xx)
    (rel,) = torch.autograd.grad(out, xx, seed)
    return out.detach(), rel


def _jax_relevance(fn, x, seed, composite):
    with jl.lrp_composite(composite):
        out, vjp = jax.vjp(fn, jnp.asarray(x))
        (rel,) = vjp(jnp.asarray(seed))
    return np.asarray(out), np.asarray(rel)


@pytest.mark.parametrize("composite", ["epsilon_plus_flat", "epsilon"])
@pytest.mark.parametrize("layer", ["linear", "conv2d"])
def test_lrp_through_a_quantized_layer_dequantizes(layer, composite):
    """Under a composite: the relevance equals JAX's through its quantized layer (atol 1e-5 + rtol 1e-4, as
    the float rules' tests) and equals the port's own through the dequantized float weight exactly."""
    rng = np.random.default_rng(60)
    if layer == "linear":
        x, w, b = _rand((3, 5, 8), 61), _rand((8, 6), 62, 0.5), _rand((6,), 63, 0.1)
        seed = rng.standard_normal((3, 5, 6)).astype(np.float32)
        jqt = jq.quantize_weight(jnp.asarray(w))
        tqt = _port_qt(jqt)
        jout, jrel = _jax_relevance(lambda xx: jl.linear(xx, jqt, jnp.asarray(b)), x, seed, composite)
        tx, tseed = _t(x), _t(seed)

        def tfn(weight):
            return lambda xx: tl.linear(xx, weight, _t(b))

        def to_jax(r):
            return r.numpy()
    else:
        x, w, b = _rand((2, 7, 7, 4), 64), _rand((3, 3, 4, 6), 65, 0.4), _rand((6,), 66, 0.2)
        seed = rng.standard_normal((2, 7, 7, 6)).astype(np.float32)
        jqt = jq.quantize_weight(jnp.asarray(w))
        tqt = _port_qt(jqt)
        jout, jrel = _jax_relevance(lambda xx: jl.conv2d(xx, jqt, jnp.asarray(b), padding=1), x, seed, composite)
        tx, tseed = _t(x).permute(0, 3, 1, 2), _t(seed).permute(0, 3, 1, 2)

        def tfn(weight):
            return lambda xx: tl.conv2d(xx, weight, _t(b), padding=1)

        def to_jax(r):
            return r.permute(0, 2, 3, 1).numpy()
    tout, trel = _torch_relevance(tfn(tqt), tx, tseed, composite)
    fout, frel = _torch_relevance(tfn(tq.dequantize(tqt)), tx, tseed, composite)
    assert torch.equal(trel, frel) and torch.equal(tout, fout)
    np.testing.assert_allclose(to_jax(tout), jout, atol=1e-5)
    np.testing.assert_allclose(to_jax(trel), jrel, atol=1e-5, rtol=1e-4)
