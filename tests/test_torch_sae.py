"""Port parity: the SAE dictionary, its objective and its optimizer against the JAX package.

The same numpy parameters and rows go through ``semanticlens_tpu.sae`` and
``semanticlens_tpu_torch.sae`` on the CPU. Tolerances are relative to the
largest magnitude of the reference value (``_close``): 1e-5 for codes,
losses and gradients (float32 sums in another order), 2e-6 for one to three
optimizer steps on identical gradients. The JumpReLU case widens ``ste_eps``
so that the rectangle kernel of the θ gradient covers many entries.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from semanticlens_tpu import sae as jsae
from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch import sae as tsae

torch.set_num_threads(2)

D_IN, N_LAT, D_OUT, ROWS = 12, 40, 7, 96


def _close(got, want, rel, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max |Δ| {err:.3g} > {rel} × {scale:.3g}"


def _configs(**kw):
    return jsae.SAEConfig(**kw), tsae.SAEConfig(**kw)


def _params(cfg_kw, seed=0):
    """The JAX init with every tensor perturbed (non-zero biases), as float32 numpy."""
    jcfg, _ = _configs(**cfg_kw)
    p = {n: np.asarray(v, np.float32) for n, v in jsae.init_sae(jax.random.PRNGKey(seed), jcfg).items()}
    rng = np.random.default_rng(seed + 1)
    out = {}
    for n, v in p.items():
        noise = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
        out[n] = (v + noise) if n != "log_theta" else np.log(rng.uniform(0.2, 0.6, v.shape)).astype(np.float32)
    return out


def _rows(n=ROWS, d=D_IN, seed=3):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _t(params):
    return {n: torch.from_numpy(v.copy()) for n, v in params.items()}


# --------------------------------------------------------------- dictionary
def test_config_checks_match():
    for kw in ({"jumprelu": True, "k": 4}, {"skip": True}):
        with pytest.raises(ValueError) as jerr:
            jsae.SAEConfig(d_in=4, n_latents=8, **kw)
        with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
            tsae.SAEConfig(d_in=4, n_latents=8, **kw)
    assert tsae.SAEConfig(d_in=4, n_latents=8, d_out=3).is_transcoder
    assert [f.name for f in jsae.dataclasses.fields(jsae.SAEConfig)] == \
        [f.name for f in tsae.dataclasses.fields(tsae.SAEConfig)]


@pytest.mark.parametrize("cfg_kw", [
    {"d_in": D_IN, "n_latents": N_LAT},
    {"d_in": D_IN, "n_latents": N_LAT, "k": 0, "jumprelu": True, "init_theta": 0.05},
    {"d_in": D_IN, "n_latents": N_LAT, "d_out": D_OUT, "skip": True},
])
def test_init_shapes_unit_rows_and_transpose(cfg_kw):
    jcfg, tcfg = _configs(**cfg_kw)
    want = jsae.init_sae(jax.random.PRNGKey(0), jcfg)
    got = tsae.init_sae(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert {n: tuple(v.shape) for n, v in got.items()} == {n: tuple(v.shape) for n, v in want.items()}
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in got.values())
    torch.testing.assert_close(torch.linalg.vector_norm(got["W_dec"], dim=1), torch.ones(N_LAT), rtol=1e-6, atol=0)
    if tcfg.is_transcoder:
        assert torch.all(got["b_in"] == 0) and torch.all(got["W_skip"] == 0)
        assert 0.5 < float(got["W_enc"].std() * np.sqrt(D_IN)) < 1.5  # lecun-normal
    else:
        assert torch.equal(got["W_enc"], got["W_dec"].T)
    if tcfg.jumprelu:
        _close(got["log_theta"], want["log_theta"], 0)
    again = tsae.init_sae(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert all(torch.equal(again[n], got[n]) for n in got)


@pytest.mark.parametrize("flavour", ["topk", "relu", "jumprelu", "transcoder", "skip"])
def test_encode_decode_match(flavour):
    kw = {"d_in": D_IN, "n_latents": N_LAT, "k": 0 if flavour in ("relu", "jumprelu") else 5}
    if flavour == "jumprelu":
        kw["jumprelu"] = True
    if flavour in ("transcoder", "skip"):
        kw.update(d_out=D_OUT, skip=flavour == "skip")
    p = _params(kw)
    x = _rows().reshape(4, 24, D_IN)  # any leading axes
    jz = jsae.encode(p, x, k=kw["k"])
    tz = tsae.encode(_t(p), torch.from_numpy(x), k=kw["k"])
    _close(tz, jz, 1e-5, "codes")
    if kw["k"]:
        assert int((tz > 0).sum(-1).max()) <= kw["k"]
    skip_x = x if flavour == "skip" else None
    _close(tsae.decode(_t(p), tz, None if skip_x is None else torch.from_numpy(skip_x)),
           jsae.decode(p, jz, skip_x), 1e-5, "decode")
    if flavour == "skip":
        with pytest.raises(ValueError, match="input rows x"):
            tsae.decode(_t(p), tz)


def test_topk_mask_keeps_ties_and_scatter_keeps_exactly_k():
    pre = np.array([[3.0, 1.0, 2.0, 2.0, -1.0], [-3.0, -1.0, -2.0, -2.0, -4.0]], np.float32)
    got = tsae._topk_mask(torch.from_numpy(pre), 3)
    _close(got, jsae._topk_mask(jnp.asarray(pre), 3), 0)
    assert got[0].tolist() == [3.0, 0.0, 2.0, 2.0, 0.0] and got[1].abs().sum() == 0
    ties = np.array([[1.0, 2.0, 2.0, 2.0, 0.5]], np.float32)
    assert int((tsae._topk_mask(torch.from_numpy(ties), 2) > 0).sum()) == 3  # ≥ k-th keeps every tie
    assert int((tsae._topk_scatter(torch.from_numpy(ties), 2) > 0).sum()) == 2
    _close(tsae._topk_scatter(torch.from_numpy(pre), 3), jsae._topk_scatter_approx(jnp.asarray(pre), 3), 0)


def test_gemma_scope_loader_matches():
    rng = np.random.default_rng(0)
    arrays = {"W_enc": rng.normal(size=(D_IN, N_LAT)).astype(np.float32),
              "b_enc": rng.normal(size=N_LAT).astype(np.float32),
              "W_dec": rng.normal(size=(N_LAT, D_IN)).astype(np.float32),
              "b_dec": rng.normal(size=D_IN).astype(np.float32),
              "threshold": np.concatenate([[0.0, -1.0], rng.uniform(0.1, 1.0, N_LAT - 2)]).astype(np.float32)}
    want = jsae.load_gemma_scope_params(arrays)
    got = tsae.load_gemma_scope_params(arrays, device="cpu")
    assert got["k"] == 0 and set(got) == set(want)
    for n in ("W_enc", "b_enc", "W_dec", "b_dec", "log_theta"):
        _close(got[n], want[n], 1e-6, n)
    x = _rows()
    published = x @ arrays["W_enc"] + arrays["b_enc"]
    published = published * (published > np.maximum(arrays["threshold"], 1e-12))  # θ ≤ 0: every positive fires
    _close(tsae.encode(got, torch.from_numpy(x)), published, 1e-5, "published convention")
    _close(tsae.encode(got, torch.from_numpy(x)), jsae.encode(want, x), 1e-5, "JAX encode")
    bad = dict(arrays, W_enc=arrays["W_enc"][:, :-1])
    with pytest.raises(ValueError, match="transposed"):
        tsae.load_gemma_scope_params(bad, device="cpu")


def test_digest_and_convert_round_trip(tmp_path):
    cfg_kw = {"d_in": D_IN, "n_latents": N_LAT, "k": 4}
    jcfg, _ = _configs(**cfg_kw)
    jp = jsae.finalize_sae_params(jsae.init_sae(jax.random.PRNGKey(2), jcfg), jcfg)
    np.savez(tmp_path / "jax.npz", **{n: np.asarray(v) for n, v in jp.items()})
    tp = convert.load_sae_npz(tmp_path / "jax.npz", device="cpu")
    assert tp["k"] == 4 and isinstance(tp["k"], int)
    assert tsae._params_digest(tp) == jsae._params_digest(jp)
    convert.save_sae_npz(tmp_path / "port.npz", tp)
    back = dict(np.load(tmp_path / "port.npz"))
    assert back["k"].dtype == np.int32 and back["k"].shape == () and int(back["k"]) == 4
    for n in ("W_enc", "b_enc", "W_dec", "b_dec"):
        np.testing.assert_array_equal(back[n], np.asarray(jp[n]))
    assert jsae._params_digest(back) == jsae._params_digest(jp)


# ---------------------------------------------------------------- objective
LOSS_CASES = {
    "topk_scatter": ({"k": 5}, None),
    "topk_mask": ({"k": 5, "approx_topk": False}, None),
    "auxk_fewer_dead_than_aux_k": ({"k": 5, "aux_k": 16, "dead_steps": 3}, 6),
    "auxk_more_dead_than_aux_k": ({"k": 5, "aux_k": 8, "dead_steps": 3}, 20),
    "auxk_none_dead": ({"k": 5, "aux_k": 8, "dead_steps": 3}, 0),
    "relu_l1": ({"k": 0, "l1_coef": 0.05}, None),
    "jumprelu": ({"k": 0, "jumprelu": True, "ste_eps": 0.5, "l0_coef": 0.01}, None),
    "transcoder": ({"k": 5, "d_out": D_OUT}, None),
    "skip_transcoder_relu": ({"k": 0, "d_out": D_OUT, "skip": True}, None),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_every_gradient_match_value_and_grad(case):
    extra, n_dead = LOSS_CASES[case]
    kw = {"d_in": D_IN, "n_latents": N_LAT, **extra}
    jcfg, tcfg = _configs(**kw)
    p = _params(kw)
    x = _rows()
    y = _rows(d=D_OUT, seed=4) if jcfg.is_transcoder else None
    last = np.zeros(N_LAT, np.int32)
    if n_dead:
        last[np.random.default_rng(5).choice(N_LAT, n_dead, replace=False)] = 10
    (jloss, (jfired, jmet)), jgrads = jax.jit(jax.value_and_grad(jsae._loss_fn, has_aux=True), static_argnums=2)(
        {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x), jcfg, jnp.asarray(last),
        None if y is None else jnp.asarray(y))
    leaves = {n: v.requires_grad_(True) for n, v in _t(p).items()}
    tloss, (tfired, tmet) = tsae._loss_fn(leaves, torch.from_numpy(x), tcfg, torch.from_numpy(last),
                                          None if y is None else torch.from_numpy(y))
    grads = dict(zip(leaves, torch.autograd.grad(tloss, list(leaves.values()))))
    _close(tloss, jloss, 1e-5, "loss")
    assert np.array_equal(tfired.numpy(), np.asarray(jfired))
    for n in jmet:
        _close(tmet[n], jmet[n], 1e-5, n)
    assert set(grads) == set(jgrads)
    for n in jgrads:
        assert np.abs(np.asarray(jgrads[n])).max() > 0 or case == "auxk_none_dead", n
        _close(grads[n], jgrads[n], 1e-5, f"∂loss/∂{n}")
    if case.startswith("auxk") and n_dead:
        plain = dict(kw, aux_k=0)
        base = tsae._loss_fn(_t(p), torch.from_numpy(x), tsae.SAEConfig(**plain), torch.from_numpy(last))[0]
        assert float(tloss.detach()) > float(base)  # AuxK is on the loss


def test_auxk_gradient_reaches_only_dead_latents():
    kw = {"d_in": D_IN, "n_latents": N_LAT, "k": 5, "aux_k": 8, "dead_steps": 3}
    p = _params(kw)
    last = np.zeros(N_LAT, np.int32)
    dead = np.arange(0, N_LAT, 4)
    last[dead] = 3
    with_aux = {n: v.requires_grad_(True) for n, v in _t(p).items()}
    loss = tsae._loss_fn(with_aux, torch.from_numpy(_rows()), tsae.SAEConfig(**kw), torch.from_numpy(last))[0]
    g_aux = torch.autograd.grad(loss, [with_aux["W_enc"]])[0]
    without = {n: v.requires_grad_(True) for n, v in _t(p).items()}
    loss0 = tsae._loss_fn(without, torch.from_numpy(_rows()), tsae.SAEConfig(**dict(kw, aux_k=0)),
                          torch.from_numpy(last))[0]
    g0 = torch.autograd.grad(loss0, [without["W_enc"]])[0]
    changed = (g_aux - g0).abs().sum(0) > 0
    assert changed.any() and set(np.flatnonzero(changed.numpy())) <= set(dead)


def test_stats_init_and_decoder_projection():
    tcfg = tsae.SAEConfig(d_in=D_IN, n_latents=N_LAT)
    st = tsae.init_stats(tcfg, device="cpu")
    assert st["last_fired"].dtype == torch.int32 and st["last_fired"].shape == (N_LAT,)
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()
    p = _params({"d_in": D_IN, "n_latents": N_LAT})
    g = {"W_dec": np.random.default_rng(9).normal(size=(N_LAT, D_IN)).astype(np.float32)}
    _close(tsae._project_decoder(_t(p), _t(g))["W_dec"], jsae._project_decoder(p, g)["W_dec"], 1e-6)
    _close(tsae._renorm_decoder(_t(p))["W_dec"], jsae._renorm_decoder(p)["W_dec"], 1e-6)


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("grad_scale", [10.0, 0.01])
def test_clip_adam_matches_optax(grad_scale):
    """Three steps of ClipAdam against optax's chain, global gradient norm above and below 1."""
    rng = np.random.default_rng(0)
    p = _params({"d_in": D_IN, "n_latents": N_LAT})
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    jp, jstate = {n: jnp.asarray(v) for n, v in p.items()}, None
    opt = tsae.ClipAdam(1e-3)
    tp = _t(p)
    tstate = opt.init(tp)
    jstate = tx.init(jp)
    for _ in range(3):
        g = {n: (grad_scale * rng.normal(size=v.shape) / np.sqrt(v.size)).astype(np.float32) for n, v in p.items()}
        norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))
        assert (norm > 1.0) == (grad_scale > 1.0)
        ju, jstate = tx.update({n: jnp.asarray(v) for n, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = opt.update(_t(g), tstate)
        tp = tsae.apply_updates(tp, tu)
        for n in jp:
            _close(tu[n], ju[n], 2e-6, f"update {n}")
            _close(tp[n], jp[n], 2e-6, n)
    assert tstate["count"] == 3


def test_clip_is_optax_not_clip_grad_norm():
    """At a global norm of exactly 2 optax scales by 1/2 where torch's clip_grad_norm_ scales by
    1/(2 + 1e-6): the first moment after one step holds (1 − b1) × the clipped gradient."""
    g = torch.tensor([2.0, 0.0, 0.0])
    opt = tsae.ClipAdam(1e-3)
    _, state = opt.update({"a": g}, opt.init({"a": g}))
    clip = optax.clip_by_global_norm(1.0)
    clipped, _ = clip.update({"a": jnp.asarray(g.numpy())}, clip.init(None))
    assert state["mu"]["a"].tolist() == (torch.tensor(np.asarray(clipped["a"])) * (1 - 0.9)).tolist()
    leaf = torch.nn.Parameter(torch.zeros(3))
    leaf.grad = g.clone()
    torch.nn.utils.clip_grad_norm_([leaf], 1.0)  # scales by 1 / (2 + 1e-6)
    assert (leaf.grad * (1 - 0.9)).tolist() != state["mu"]["a"].tolist()
