"""The port's interventions stack against the JAX package's, case by case.

The cases of JAX ``tests/test_causal.py`` (context, threads, engine) and
``tests/models/test_interventions_causal.py`` / ``test_tap_contract.py``
(every rewrite is causal, a requested tap holds the post-intervention
value, the per-head attention taps, adapters refuse) run on the same numpy
weights in both packages: a two-layer linear tap model (outputs within
1e-6), ResNet-18 and a two-block ViT at 32² (within 1e-4 of the output
scale: float32 convolutions summed in another order). The SAE and
transcoder causal paths (JAX ``sae.py:888-921, 1014-1039``) are held the
same way. A conv rewrite sees the (B, H, W, C) activation in both packages,
although the port's ResNet runs NCHW.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semanticlens_tpu import sae as jsae
from semanticlens_tpu.collect.engine import CollectEngine as JEngine
from semanticlens_tpu.data import ArrayDataset as JDS
from semanticlens_tpu.models import base as jbase
from semanticlens_tpu.models.resnet import ResNet as JResNet
from semanticlens_tpu.models.vit import VisionTransformer as JViT
from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch import sae as tsae
from semanticlens_tpu_torch.collect.engine import CollectEngine as TEngine
from semanticlens_tpu_torch.data import ArrayDataset as TDS
from semanticlens_tpu_torch.models import base as tbase
from semanticlens_tpu_torch.models import ResNet as TResNet
from semanticlens_tpu_torch.models import TorchSubjectModel
from semanticlens_tpu_torch.models import VisionTransformer as TViT

torch.set_num_threads(2)

RNG = np.random.default_rng(0)
W1, W2 = RNG.normal(size=(6, 4)).astype(np.float32), RNG.normal(size=(4, 3)).astype(np.float32)
X = RNG.normal(size=(5, 6)).astype(np.float32)
IMAGES = np.random.default_rng(1).random((4, 32, 32, 3)).astype(np.float32)


class JLinear(jbase.SubjectModel):
    module_names = ("hidden", "head")

    def apply(self, params, x, tap_names=()):
        tap = jbase.TapCollector(tap_names)
        h = tap("hidden", x @ params["w1"])
        return tap("head", h @ params["w2"]), tap.taps


class TLinear(tbase.SubjectModel):
    module_names = ("hidden", "head")
    device = torch.device("cpu")

    def apply(self, params, x, tap_names=()):
        tap = tbase.TapCollector(tap_names)
        h = tap("hidden", x @ params["w1"])
        return tap("head", h @ params["w2"]), tap.taps


PKGS = {
    "jax": (JLinear(), {"w1": jnp.asarray(W1), "w2": jnp.asarray(W2)}, jnp.asarray(X), jbase, jnp),
    "torch": (TLinear(), {"w1": torch.from_numpy(W1), "w2": torch.from_numpy(W2)}, torch.from_numpy(X), tbase, torch),
}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# (name, [mapping of each nested context, outermost first], taps requested)
STACKS = [
    ("zero-hidden", [{"hidden": lambda v: v * 0.0}], ("hidden",)),
    ("nested-same-name", [{"hidden": lambda v: v * 2.0}, {"hidden": lambda v: v + 1.0}], ("hidden", "head")),
    ("nested-two-names", [{"hidden": lambda v: v * 2.0}, {"head": lambda v: v - 1.0}], ("hidden", "head")),
    ("inner-first-would-differ", [{"hidden": lambda v: v + 1.0}, {"hidden": lambda v: v * 3.0}], ("hidden",)),
]


def _run_stack(pkg, stack, taps):
    model, params, x, base, _ = PKGS[pkg]
    contexts = [base.interventions(m) for m in stack]
    for c in contexts:
        c.__enter__()
    try:
        out, got = model.apply(params, x, taps)
    finally:
        for c in reversed(contexts):
            c.__exit__(None, None, None)
    clean, _ = model.apply(params, x)
    return _np(out), {k: _np(v) for k, v in got.items()}, _np(clean)


@pytest.mark.parametrize("name,stack,taps", STACKS, ids=[s[0] for s in STACKS])
def test_stack_order_nesting_and_post_intervention_taps_match_jax(name, stack, taps):
    jout, jtaps, jclean = _run_stack("jax", stack, taps)
    tout, ttaps, tclean = _run_stack("torch", stack, taps)
    np.testing.assert_allclose(tout, jout, rtol=1e-6, atol=1e-6)
    assert set(ttaps) == set(jtaps) == set(taps)
    for k in taps:
        np.testing.assert_allclose(ttaps[k], jtaps[k], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tclean, X @ W1 @ W2, rtol=1e-5, atol=1e-5)  # the context exits cleanly
    np.testing.assert_allclose(tclean, jclean, rtol=1e-6, atol=1e-6)
    if name == "zero-hidden":
        assert np.allclose(tout, 0.0) and np.allclose(ttaps["hidden"], 0.0)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_tokens_queries_and_apply_order(pkg):
    _, _, _, base, _ = PKGS[pkg]
    assert base.interventions_fingerprint() == () and not base.has_intervention("hidden")
    with base.interventions({"hidden": lambda v: v * 2.0}):
        outer = base.interventions_fingerprint()
        with base.interventions({"hidden": lambda v: v + 1.0, "head": lambda v: -v}):
            inner = base.interventions_fingerprint()
            assert base.has_intervention("head") and not base.has_intervention("nope")
            assert base.apply_interventions("hidden", 1.0) == 3.0  # outermost first: (1·2)+1
            assert base.apply_interventions("nope", 5.0) == 5.0
        assert base.interventions_fingerprint() == outer and not base.has_intervention("head")
    with base.interventions({}):
        again = base.interventions_fingerprint()
    assert len(outer) == 1 and len(inner) == 2 and inner[0] == outer[0] and inner[1] > inner[0]
    assert again[0] > inner[1]  # every context gets a fresh token
    assert base.interventions_fingerprint() == ()


def test_interventions_are_thread_local():
    model, params, x, base, _ = PKGS["torch"]
    results = {}

    def clean_forward():
        results["clean"] = _np(model.apply(params, x)[0])

    with base.interventions({"hidden": lambda v: torch.zeros_like(v)}):
        t = threading.Thread(target=clean_forward)
        t.start()
        t.join(timeout=60)
        out_in, _ = model.apply(params, x)
    assert not t.is_alive()
    assert np.abs(results["clean"]).sum() > 0, "the other thread saw the intervention"
    assert np.allclose(_np(out_in), 0.0)


def _ident(a):
    return a


def test_engine_sees_the_active_interventions_as_jax_does():
    """The JAX engine keys its memoized step on the fingerprint; the port's engine memoizes nothing, so
    a clean → intervened → clean sequence gives the JAX package's three results."""
    rows = np.abs(np.random.default_rng(0).normal(size=(8, 6))).astype(np.float32)
    out = {}
    for pkg, engine_cls, ds_cls in (("jax", JEngine, JDS), ("torch", TEngine, TDS)):
        model, params, _, base, _ = PKGS[pkg]
        eng = engine_cls(model=model, layer_names=["hidden"], aggregation_fn=_ident, n_collect=3)
        ds = ds_cls(rows, name="causal-engine")
        zeros = (lambda v: jnp.zeros_like(v)) if pkg == "jax" else (lambda v: torch.zeros_like(v))
        clean = eng.run(params, ds, batch_size=4)[0]["hidden"]
        with base.interventions({"hidden": zeros}):
            ablated = eng.run(params, ds, batch_size=4)[0]["hidden"]
        clean2 = eng.run(params, ds, batch_size=4)[0]["hidden"]
        out[pkg] = [(_np(s.values.astype(jnp.float32) if pkg == "jax" else s.values.float()), _np(s.ids))
                    for s in (clean, ablated, clean2)]
    for (jv, ji), (tv, ti) in zip(out["jax"], out["torch"]):
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti, ji)
    assert np.abs(out["torch"][0][0]).sum() > 0 and np.allclose(out["torch"][1][0], 0.0)


# ------------------------------------------------------------------ real families
@pytest.fixture(scope="module")
def resnets():
    tmodel = TResNet(depth=18, num_classes=10, dtype=torch.float32, device="cpu")
    npp = tmodel.init_jax_layout(0)
    rng = np.random.default_rng(5)
    for name in npp:  # non-trivial BN statistics and biases
        if npp[name].ndim == 1:
            npp[name] = npp[name] + rng.uniform(0.0, 0.2, size=npp[name].shape).astype(np.float32)
    tmodel.params = tmodel.load_jax_params(npp)
    jmodel = JResNet(depth=18, num_classes=10, dtype=jnp.float32)
    jmodel.params = {k: jnp.asarray(v) for k, v in npp.items()}
    return jmodel, tmodel


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, f"{what}: max |Δ| {err:.3g} > {rel} × {scale:.3g}"


def _ramp(mod):
    """The JAX tap-contract test's channel-varying shift (a uniform one sits in LayerNorm's null space)."""
    def perturb(v):
        ramp = mod.arange(v.shape[-1], dtype=mod.float32) / max(1, v.shape[-1])
        return v + (1.0 + ramp).astype(v.dtype) if mod is jnp else v + (1.0 + ramp).to(v.dtype)
    return perturb


RESNET_NAMES = ["conv1", "bn1", "maxpool", "layer1.0.conv1", "layer1.1.relu", "layer2.0.downsample.1", "layer2",
                "layer3.1.bn2", "layer4", "avgpool", "fc"]


@pytest.mark.parametrize("name", RESNET_NAMES)
def test_resnet_rewrites_are_causal_and_match_jax(resnets, name):
    jmodel, tmodel = resnets
    jclean, _ = jmodel.apply(jmodel.params, jnp.asarray(IMAGES))
    with jbase.interventions({name: _ramp(jnp)}):
        jout, jtaps = jmodel.apply(jmodel.params, jnp.asarray(IMAGES), (name,))
    with tbase.interventions({name: _ramp(torch)}):
        tout, ttaps = tmodel.apply(tmodel.params, torch.from_numpy(IMAGES), (name,))
    assert np.abs(np.asarray(jout) - np.asarray(jclean)).max() > 0
    _close(tout.numpy(), jout, 1e-4, f"{name} output")
    _close(ttaps[name].numpy(), jtaps[name], 1e-4, f"{name} post-intervention tap")
    # the requested tap holds the rewritten activation, ramp(clean)
    _, clean_taps = tmodel.apply(tmodel.params, torch.from_numpy(IMAGES), (name,))
    _close(ttaps[name].numpy(), _ramp(torch)(clean_taps[name]).numpy(), 1e-6, f"{name} tap = ramp(clean)")


@pytest.fixture(scope="module")
def vits():
    kw = dict(image_size=32, patch_size=8, width=32, depth=2, heads=2, num_classes=4)
    tmodel = TViT(**kw, dtype=torch.float32, device="cpu")
    jmodel = JViT(**kw, dtype=jnp.float32)
    npp = tmodel.init_jax_layout(0)
    rng = np.random.default_rng(3)
    for name in npp:
        if npp[name].ndim == 1:
            npp[name] = npp[name] + rng.normal(scale=0.1, size=npp[name].shape).astype(np.float32)
    tmodel.params = tmodel.load_jax_params(npp)
    jmodel.params = {k: jnp.asarray(v) for k, v in npp.items()}
    return jmodel, tmodel


@pytest.mark.parametrize("rewrite", ["ablate-head-1", "scale-heads", "identity"])
def test_vit_head_interventions_match_jax(vits, rewrite):
    jmodel, tmodel = vits
    heads = "blocks.0.attn.heads"
    mask = np.ones((1, 1, 2), np.float32)
    mask[..., 1] = 0.0
    fns = {"ablate-head-1": (lambda v: v * jnp.asarray(mask), lambda v: v * torch.from_numpy(mask)),
           "scale-heads": (lambda v: v * 2.0, lambda v: v * 2.0),
           "identity": (lambda v: v, lambda v: v)}[rewrite]
    x = IMAGES[:3]
    jclean, _ = jmodel.apply(jmodel.params, jnp.asarray(x))
    tclean, _ = tmodel.apply(tmodel.params, torch.from_numpy(x))
    with jbase.interventions({heads: fns[0]}):
        jout, jtaps = jmodel.apply(jmodel.params, jnp.asarray(x), (heads,))
    with tbase.interventions({heads: fns[1]}):
        tout, ttaps = tmodel.apply(tmodel.params, torch.from_numpy(x), (heads,))
    _close(tout.numpy(), jout, 1e-4, "output")
    _close(ttaps[heads].numpy(), jtaps[heads], 1e-4, "heads tap")
    if rewrite == "identity":  # the rescaled sum equals the plain projection
        _close(tout.numpy(), tclean.numpy(), 1e-5, "identity rewrite")
    else:
        assert float((tout - tclean).abs().max()) > 1e-4
    if rewrite == "ablate-head-1":
        assert float(ttaps[heads][..., 1].abs().max()) == 0.0


def test_torch_subject_model_refuses_interventions_as_jax_does():
    from semanticlens_tpu.models import TorchSubjectModel as JTorchSubjectModel

    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.ReLU()).eval()
    port, jax_ = TorchSubjectModel(net, name="t", device="cpu"), JTorchSubjectModel(net, name="t")
    layer = port.module_names[0]
    with jbase.interventions({layer: lambda v: v + 1.0}):
        with pytest.raises(NotImplementedError, match="TorchSubjectModel"):
            jax_.apply({}, jnp.zeros((1, 8, 8, 3), jnp.float32), ())
    with tbase.interventions({layer: lambda v: v + 1.0}):
        with pytest.raises(NotImplementedError, match=rf"TorchSubjectModel modules \['{layer}'\]"):
            port.apply({}, torch.zeros(1, 8, 8, 3), ())
    with tbase.interventions({"not-a-module": lambda v: v}):  # other names: the forward runs
        assert port.apply({}, torch.zeros(1, 8, 8, 3), (layer,))[1][layer].shape == (1, 6, 6, 4)


# ----------------------------------------------------------- SAE virtual taps
N_LAT, K = 64, 4


def _dictionary(**kw):
    cfg = jsae.SAEConfig(n_latents=N_LAT, k=K, **kw)
    rng = np.random.default_rng(len(kw))
    p = {n: np.asarray(v) + rng.normal(scale=0.05, size=v.shape).astype(np.float32)
         for n, v in jsae.init_sae(jax.random.PRNGKey(1), cfg).items()}
    jp = jsae.finalize_sae_params({n: jnp.asarray(v) for n, v in p.items()}, cfg)
    return jp, convert.sae_params_from_jax({n: np.asarray(v) for n, v in jp.items()}, device="cpu")


def _latent_rewrites(mod):
    keep = np.ones(N_LAT, np.float32)
    keep[:8] = 0.0
    arr = jnp.asarray(keep) if mod is jnp else torch.from_numpy(keep)
    return {"ablate-8-latents": lambda z: z * arr, "identity": lambda z: z, "double": lambda z: z * 2.0}


@pytest.mark.parametrize("rewrite", ["ablate-8-latents", "identity", "double"])
def test_sae_subject_causal_path_matches_jax(resnets, rewrite):
    jmodel, tmodel = resnets
    jp, tp = _dictionary(d_in=128)
    jsub, tsub = jsae.SAESubjectModel(jmodel, "layer2", jp), tsae.SAESubjectModel(tmodel, "layer2", tp)
    with jbase.interventions({"layer2.sae": _latent_rewrites(jnp)[rewrite]}):
        jout, jtaps = jsub.apply(jsub.params, jnp.asarray(IMAGES), ("layer2.sae", "layer2"))
    with tbase.interventions({"layer2.sae": _latent_rewrites(torch)[rewrite]}):
        tout, ttaps = tsub.apply(tsub.params, torch.from_numpy(IMAGES), ("layer2.sae", "layer2"))
    _close(tout.numpy(), jout, 1e-4, "output")
    _close(ttaps["layer2.sae"].numpy(), jtaps["layer2.sae"], 1e-4, "rewritten codes")
    _close(ttaps["layer2"].numpy(), jtaps["layer2"], 1e-4, "substituted layer")
    clean, _ = tsub.apply(tsub.params, torch.from_numpy(IMAGES), ())
    assert float((tout - clean).abs().max()) > 0  # the substitution (and the rewrite) reach the output


def test_sae_subject_refuses_a_transcoder_dictionary_under_an_intervention(resnets):
    jmodel, tmodel = resnets
    jp, tp = _dictionary(d_in=128, d_out=128)
    jsub, tsub = jsae.SAESubjectModel(jmodel, "layer2", jp), tsae.SAESubjectModel(tmodel, "layer2", tp)
    with jbase.interventions({"layer2.sae": lambda z: z}):
        with pytest.raises(ValueError, match="transcoder"):
            jsub.apply(jsub.params, jnp.asarray(IMAGES), ())
    with tbase.interventions({"layer2.sae": lambda z: z}):
        with pytest.raises(ValueError, match="transcoder"):
            tsub.apply(tsub.params, torch.from_numpy(IMAGES), ())


@pytest.mark.parametrize("skip", [False, True], ids=["plain", "skip"])
@pytest.mark.parametrize("how", ["replace", "intervention", "both"])
def test_transcoder_patch_path_matches_jax(resnets, skip, how):
    """``replace=True`` and/or an intervention on ``"{tap_in}.tc"`` substitute ``tap_out`` with the
    (rewritten) prediction, ``W_skip`` included, as the JAX package does."""
    jmodel, tmodel = resnets
    jp, tp = _dictionary(d_in=128, d_out=128, skip=skip)
    replace = how in ("replace", "both")
    jsub = jsae.TranscoderSubjectModel(jmodel, "layer2.0", "layer2.1", jp, replace=replace)
    tsub = tsae.TranscoderSubjectModel(tmodel, "layer2.0", "layer2.1", tp, replace=replace)
    taps = ("layer2.0.tc", "layer2.1")
    if how == "replace":
        jout, jtaps = jsub.apply(jsub.params, jnp.asarray(IMAGES), taps)
        tout, ttaps = tsub.apply(tsub.params, torch.from_numpy(IMAGES), taps)
    else:
        with jbase.interventions({"layer2.0.tc": _latent_rewrites(jnp)["ablate-8-latents"]}):
            jout, jtaps = jsub.apply(jsub.params, jnp.asarray(IMAGES), taps)
        with tbase.interventions({"layer2.0.tc": _latent_rewrites(torch)["ablate-8-latents"]}):
            tout, ttaps = tsub.apply(tsub.params, torch.from_numpy(IMAGES), taps)
    _close(tout.numpy(), jout, 1e-4, "output")
    _close(ttaps["layer2.0.tc"].numpy(), jtaps["layer2.0.tc"], 1e-4, "codes")
    _close(ttaps["layer2.1"].numpy(), jtaps["layer2.1"], 1e-4, "substituted target tap")
    plain = tsae.TranscoderSubjectModel(tmodel, "layer2.0", "layer2.1", tp)
    clean, _ = plain.apply(plain.params, torch.from_numpy(IMAGES), ())
    assert float((tout - clean).abs().max()) > 0 and set(ttaps) == set(taps)
