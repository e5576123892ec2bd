"""Learned float attention biases (Swin, Swin-V2, MaxViT) against the JAX package, float32 and bf16.

- ``layers.scaled_dot_product_attention`` with a per-head (H, T, S) and a
  batched (B, H, T, S) float mask, ``float32_mask=True``: forward and CP-LRP
  relevance against the JAX helper (whose ``to_4d`` casts every mask to
  float32 and adds it to float32 logits), in float32 and in bf16; a
  (G, H, T, S) mask with period G over the rows equals the same mask
  materialised per row.
- bf16 against JAX bf16 on the CPU, the same numpy weights (bias tables and
  CPB weights with a trained model's spread):
  * one windowed attention (Swin's shifted block, Swin-V2's, MaxViT's
    relative-position MHA) on the same bf16 input: the mean |Δ| over the
    mean |output| within ``ATTN_MEAN_REL`` (measured ≤ 4.5e-6: the two
    differ by sparse one-ulp flips), the max within two bf16 ulps of the
    scale. The control rounds the tables (and CPB weights) to bf16 and the
    mask to q's dtype, what the port did before the bias stayed float32:
    its mean gap is 3.8e-3–1.4e-2, so it breaks the bound;
  * the whole Swin-T, Swin-V2-T and MaxViT-T: logits and each stage tap
    within ``MODEL_MEAN_REL`` of the scale by mean |Δ| (measured ≤ 0.033,
    Swin-V2-T's last stage) and ``MODEL_MAX_REL`` by max (measured ≤ 0.040).
    Here bf16 rounding of the activations (LayerNorm, BatchNorm, GELU,
    matmul order) is 1–4 % and the bias control moves it by < 1 %: the
    rounding of the tables cannot show at this level, which is why the
    attention-level test carries the control.
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
from semanticlens_tpu_torch.models import maxvit as tmaxvit
from semanticlens_tpu_torch.models import swin as tswin

from test_torch_zoo2_models import trained_spread

torch.set_num_threads(2)

ATTN_MEAN_REL = 1e-4
ATTN_MAX_REL = 2**-7
MODEL_MEAN_REL = 0.05
MODEL_MAX_REL = 0.08
B, T_, H, HD = 6, 16, 3, 8


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(dtype)


def _qkv_mask(kind):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(B, T_, H * HD)).astype(np.float32) for _ in range(3))
    shape = {"per_head": (H, T_, T_), "batched": (B, H, T_, T_)}[kind]
    mask = (rng.normal(size=shape) * 3).astype(np.float32)
    mask[..., 0, 1] = -100.0  # a region-mask entry beside the learned values
    return q, k, v, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["per_head", "batched"])
def test_float_mask_matches_jax(kind, dtype):
    q, k, v, mask = _qkv_mask(kind)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want = np.asarray(jl.scaled_dot_product_attention(jq, jk, jv, H, mask=jnp.asarray(mask)).astype(jnp.float32))
    tq, tk, tv = (_to_torch(a, tdt) for a in (jq, jk, jv))
    got = tl.scaled_dot_product_attention(tq, tk, tv, H, mask=torch.from_numpy(mask), float32_mask=True)
    assert got.dtype == tdt
    bound = 2e-6 if dtype == "float32" else 2**-8  # one bf16 ulp of the scale
    assert np.abs(got.float().numpy() - want).max() <= bound * np.abs(want).max()

    # CP-LRP: the mask is part of the constant probabilities
    def jrel(vv):
        with jl.lrp_composite("epsilon", epsilon=1e-6):
            out, vjp = jax.vjp(lambda x: jl.scaled_dot_product_attention(jq, jk, x, H, mask=jnp.asarray(mask)), vv)
            return vjp(out)[0]

    want_r = np.asarray(jax.jit(jrel)(jv).astype(jnp.float32))
    tv = tv.clone().requires_grad_(True)
    with tl.lrp_composite("epsilon", epsilon=1e-6):
        out = tl.scaled_dot_product_attention(tq, tk, tv, H, mask=torch.from_numpy(mask), float32_mask=True)
    (got_r,) = torch.autograd.grad(out, tv, out.detach())
    assert np.abs(got_r.float().numpy() - want_r).max() <= 4 * bound * np.abs(want_r).max()


@pytest.mark.parametrize("lrp", [False, True])
def test_periodic_mask_equals_the_materialised_one(lrp):
    """A (G, H, T, S) mask with period G over the B = 3·G rows: row i takes mask[i % G]."""
    q, k, v, _ = _qkv_mask("batched")
    g = 2
    mask = torch.from_numpy(np.random.default_rng(1).normal(size=(g, H, T_, T_)).astype(np.float32))
    args = [torch.from_numpy(a) for a in (q, k, v)]
    with tl.lrp_composite("epsilon") if lrp else torch.no_grad():
        got = tl.scaled_dot_product_attention(*args, H, mask=mask, float32_mask=True)
        want = tl.scaled_dot_product_attention(*args, H, mask=mask.repeat(B // g, 1, 1, 1), float32_mask=True)
    assert torch.equal(got, want)


# ------------------------------------------------------------- bf16 against JAX bf16
def _rounded_sdpa(q, k, v, n_heads, *, mask=None, float32_mask=False, **kw):
    """The control: the mask rounded to q's dtype before it meets the logits."""
    mask = None if mask is None else mask.to(q.dtype)
    return tl.scaled_dot_product_attention(q, k, v, n_heads, mask=mask, float32_mask=float32_mask, **kw)


def _rounded_tables(params):
    return {k: v.to(torch.bfloat16).float() if ("relative_position_bias_table" in k or ".cpb_mlp." in k) else v
            for k, v in params.items()}


ATTENTIONS = {
    "swin": ("SwinTransformer", (2, 14, 14, 96)),
    "swin_v2": ("SwinTransformerV2", (2, 16, 16, 96)),
    "maxvit": ("MaxViT", (128, 49, 64)),
}


def _attention_fns(case, jm, jp, tm):
    if case == "maxvit":
        at = "blocks.0.layers.1.layers.window_attention"
        return lambda x: jm._attention(jp, x, at, 2), lambda p, x: tm._attention(p, x, at, 2)
    shift = tm.window // 2
    return (lambda x: jm._window_attention(jp, x, "features.1.1", 3, shift, jbase.TapCollector(())),
            lambda p, x: tm._window_attention(p, x, "features.1.1", 3, shift, tbase.TapCollector(())))


@pytest.mark.parametrize("case", list(ATTENTIONS))
def test_bf16_attention_matches_jax_and_the_rounded_bias_control_does_not(case, monkeypatch):
    cls, shape = ATTENTIONS[case]
    jm = getattr(J, cls)(dtype=jnp.bfloat16)
    tm = getattr(T, cls)(dtype=torch.bfloat16, device="cpu")
    weights = trained_spread(tm.init_jax_layout(0))
    jp = {k: jnp.asarray(v) for k, v in weights.items()}
    tp = tm.load_jax_params(weights)
    jfn, tfn = _attention_fns(case, jm, jp, tm)
    x = _bf16(np.random.default_rng(1).normal(size=shape).astype(np.float32))
    want = np.asarray(jax.jit(jfn)(x).astype(jnp.float32))

    def gaps(params):
        with torch.no_grad():
            d = np.abs(tfn(params, _to_torch(x, torch.bfloat16)).float().numpy() - want)
        return d.mean() / np.abs(want).mean(), d.max() / np.abs(want).max()

    mean_rel, max_rel = gaps(tp)
    assert mean_rel <= ATTN_MEAN_REL and max_rel <= ATTN_MAX_REL
    monkeypatch.setattr(tswin, "scaled_dot_product_attention", _rounded_sdpa)
    monkeypatch.setattr(tmaxvit, "scaled_dot_product_attention", _rounded_sdpa)
    control_mean, _ = gaps(_rounded_tables(tp))
    assert control_mean > 10 * ATTN_MEAN_REL


MODELS = [("SwinTransformer", 56, 2), ("SwinTransformerV2", 56, 2), ("MaxViT", 224, 1)]


@pytest.mark.parametrize("cls,size,batch", MODELS, ids=[m[0] for m in MODELS])
def test_bf16_forward_matches_jax_bf16(cls, size, batch):
    jm = getattr(J, cls)(dtype=jnp.bfloat16)
    tm = getattr(T, cls)(dtype=torch.bfloat16, device="cpu")
    weights = trained_spread(tm.init_jax_layout(0))
    jp = {k: jnp.asarray(v) for k, v in weights.items()}
    names = tuple(n for n in jm.module_names if n.count(".") <= 1 and n not in ("stem.0", "stem.1"))
    x = np.random.default_rng(1).normal(size=(batch, size, size, 3)).astype(np.float32)
    jout, jtaps = jax.jit(lambda p, xx: jm.apply(p, xx, names))(jp, jnp.asarray(x))
    with torch.no_grad():
        tout, ttaps = tm.apply(tm.load_jax_params(weights), torch.from_numpy(x), names)
    assert tout.dtype == torch.bfloat16
    for got, want in [(tout, jout)] + [(ttaps[n], jtaps[n]) for n in jtaps]:
        want = np.asarray(want.astype(jnp.float32))
        d = np.abs(got.float().numpy() - want)
        assert d.mean() <= MODEL_MEAN_REL * np.abs(want).mean() and d.max() <= MODEL_MAX_REL * np.abs(want).max()
