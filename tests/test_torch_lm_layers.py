"""Port parity: the LM layer ops of ``models/layers.py`` against the JAX package's, forward and LRP.

RMSNorm, SiLU, ``gate_scale``, ``channel_scale``, ``edge_pad_mask`` and
scaled-dot-product attention with grouped-query heads (kv heads 1, 2 and
all), a decoupled scale, the tanh soft cap and (T, S) / (B, 1, T, S) pad
masks, on the same numpy inputs in float32 on the CPU: forwards within
1e-6 relative, and the composite's relevance (the port's autograd VJP
under ``lrp_composite`` against ``jax.vjp`` under the JAX composite) within
1e-5 of the largest. The attention forward of the existing callers (no
GQA, default scale) is ``F.scaled_dot_product_attention`` bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from semanticlens_tpu.models import layers as jl
from semanticlens_tpu_torch.models import layers as tl
from test_torch_lrp import _jax_vjp, _t, _torch_vjp

torch.set_num_threads(2)

B, T, H, HD = 2, 7, 4, 8
RNG = np.random.default_rng(0)
X = RNG.normal(size=(B, T, 24)).astype(np.float32)
W = (1.0 + 0.3 * RNG.normal(size=(24,))).astype(np.float32)
GATE = RNG.normal(size=(B, T, 24)).astype(np.float32)
SEED_R = RNG.normal(size=(B, T, 24)).astype(np.float32)


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


# name → (port fn, JAX fn) of the input tensor
ELEMENTWISE = {
    "rms_norm": (lambda x: tl.rms_norm(x, _t(W), eps=1e-5), lambda x: jl.rms_norm(x, jnp.asarray(W), eps=1e-5)),
    "silu": (tl.silu, jl.silu),
    "gate_scale": (lambda x: tl.gate_scale(x, _t(GATE)), lambda x: jl.gate_scale(x, jnp.asarray(GATE))),
    "channel_scale": (lambda x: tl.channel_scale(x, _t(W)), lambda x: jl.channel_scale(x, jnp.asarray(W))),
    "channel_scale_scalar": (lambda x: tl.channel_scale(x, torch.tensor(8.0)),
                             lambda x: jl.channel_scale(x, jnp.asarray(8.0))),
}


@pytest.mark.parametrize("composite", ["none", "epsilon_plus_flat", "epsilon", "gradient"])
@pytest.mark.parametrize("op", list(ELEMENTWISE))
def test_elementwise_ops_forward_and_relevance_match_jax(op, composite):
    tfn, jfn = ELEMENTWISE[op]
    if composite == "none":
        assert rel(tfn(_t(X)).numpy(), jfn(jnp.asarray(X))) <= 1e-6
        return
    jout, (jr,) = _jax_vjp(jfn, [X], SEED_R, composite)
    tout, (tr,) = _torch_vjp(tfn, [_t(X)], _t(SEED_R), composite)
    assert rel(tout.numpy(), jout) <= 1e-6
    assert rel(tr.numpy(), jr) <= 1e-5


def test_rms_norm_and_gate_rules_conserve_per_coordinate():
    """Detached denominator and constant gate: R_x = R (ε aside) coordinate by coordinate."""
    for fn in (ELEMENTWISE["rms_norm"][0], ELEMENTWISE["gate_scale"][0], ELEMENTWISE["silu"][0]):
        _, (r,) = _torch_vjp(fn, [_t(X)], _t(SEED_R), "epsilon", epsilon=1e-9)
        np.testing.assert_allclose(r.numpy(), SEED_R, rtol=1e-4, atol=1e-4)


def test_edge_pad_mask_matches_jax():
    ids = np.array([[0, 0, 5, 0, 7, 0], [3, 0, 0, 4, 0, 0], [0, 0, 0, 0, 0, 0], [1, 2, 3, 4, 5, 6]], np.int32)
    got = tl.edge_pad_mask(_t(ids), 0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jl.edge_pad_mask(jnp.asarray(ids), 0)))
    assert got[0].tolist() == [True, True, False, False, False, True]


def _qkv(kv_heads, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H * HD)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, kv_heads * HD)).astype(np.float32) * s for s in (2.0, 1.0))
    return q, k, v


def _mask(kind):
    if kind == "none":
        return None
    causal = np.where(np.tril(np.ones((T, T), bool)), 0.0, -np.inf).astype(np.float32)
    if kind == "2d":
        return causal
    pad = np.zeros((B, T), bool)
    pad[1, :3] = True  # row 1 left-padded: pad keys dropped, each query keeps itself
    allowed = np.tril(np.ones((T, T), bool))[None] & (~pad[:, None, :] | np.eye(T, dtype=bool)[None])
    return np.where(allowed, 0.0, -np.inf).astype(np.float32)[:, None]


SDPA_CASES = [(kv, scale, cap, mask) for kv in (1, 2, H) for scale, cap in ((None, None), (0.3, None), (0.3, 1.5))
              for mask in ("none", "2d", "4d")]


@pytest.mark.parametrize("kv,scale,cap,mask", SDPA_CASES,
                         ids=[f"kv{c[0]}-scale{c[1]}-cap{c[2]}-{c[3]}" for c in SDPA_CASES])
def test_attention_forward_and_cp_lrp_match_jax(kv, scale, cap, mask):
    q, k, v = _qkv(kv)
    m = _mask(mask)
    kw = dict(n_kv_heads=kv, scale=scale, logit_cap=cap)
    jout = jl.scaled_dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H,
                                           mask=None if m is None else jnp.asarray(m), **kw)
    tout = tl.scaled_dot_product_attention(_t(q), _t(k), _t(v), H, mask=None if m is None else _t(m), **kw)
    assert rel(tout.numpy(), jout) <= 1e-6
    # a relevance-like seed (R ∝ z) and ε = 1e-2 keep the rule's R / (z ± ε) well conditioned
    # where an output z is near 0, where float32 rounding of z alone would move R / z
    seed = (np.asarray(jout) * (1.0 + 0.5 * np.random.default_rng(2).normal(size=q.shape))).astype(np.float32)
    jm, tm = (None, None) if m is None else (jnp.asarray(m), _t(m))
    jo, (jr,) = _jax_vjp(lambda vv: jl.scaled_dot_product_attention(jnp.asarray(q), jnp.asarray(k), vv, H, mask=jm,
                                                                    **kw), [v], seed, "epsilon", epsilon=1e-2)
    to, (tr,) = _torch_vjp(lambda vv: tl.scaled_dot_product_attention(_t(q), _t(k), vv, H, mask=tm, **kw),
                           [_t(v)], _t(seed), "epsilon", epsilon=1e-2)
    assert rel(to.numpy(), jo) <= 1e-6
    assert rel(tr.numpy(), jr) <= 1e-5


def test_gqa_groups_consecutive_query_heads_per_kv_head():
    """kv head g serves query heads g·G … g·G+G−1 (``repeat_interleave``), not g, g+KV, … (``repeat``)."""
    q, k, v = _qkv(2)
    grouped = tl.scaled_dot_product_attention(_t(q), _t(k), _t(v), H, n_kv_heads=2)
    k_full = _t(k).reshape(B, T, 2, HD).repeat_interleave(2, dim=2).reshape(B, T, H * HD)
    v_full = _t(v).reshape(B, T, 2, HD).repeat_interleave(2, dim=2).reshape(B, T, H * HD)
    torch.testing.assert_close(grouped, tl.scaled_dot_product_attention(_t(q), k_full, v_full, H), rtol=0, atol=0)


def test_existing_callers_see_plain_sdpa_bit_for_bit():
    q, k, v = _qkv(H)
    m = _t(_mask("2d"))

    def split(z):
        return z.reshape(B, T, H, HD).transpose(1, 2)

    for mask in (None, m):
        want = F.scaled_dot_product_attention(split(_t(q)), split(_t(k)), split(_t(v)), attn_mask=mask)
        got = tl.scaled_dot_product_attention(_t(q), _t(k), _t(v), H, mask=mask)
        assert torch.equal(got, want.transpose(1, 2).reshape(B, T, H * HD))


def test_bf16_pad_mask_keeps_rows_finite():
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(2))
    out = tl.scaled_dot_product_attention(q, k, v, H, mask=_t(_mask("4d")), n_kv_heads=2)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
