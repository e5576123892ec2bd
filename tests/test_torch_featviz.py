"""``semanticlens_tpu_torch.featviz`` against ``semanticlens_tpu.featviz`` on the same weights.

A two-conv tap model (the JAX synthesis tests' ``TinyConvNet``) and
ResNet-18 carry the same numpy weights in both packages. The random streams
differ (a CPU ``torch.Generator`` against ``jax.random``), so the test
computes the canvas init ``z0`` and every step's window offset and flips
from the JAX keys exactly as the JAX step does, injects them into the port
(``featviz._init_canvas`` / ``featviz._draws``), and holds images,
objectives and the trace within 1e-5 (float32; ResNet-18's images within
1e-4, for the reason its test gives). ``sae.Adam`` is held
against ``optax.adam`` as ``ClipAdam`` is against optax's chain.
"""

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from semanticlens_tpu import featviz as jfv
from semanticlens_tpu.models.base import SubjectModel as JSubject
from semanticlens_tpu.models.base import TapCollector as JTap
from semanticlens_tpu.models.layers import conv2d as jconv2d
from semanticlens_tpu.models.resnet import ResNet as JResNet
from semanticlens_tpu.ops.aggregators import aggregate_conv_mean as j_mean
from semanticlens_tpu_torch import featviz as tfv
from semanticlens_tpu_torch import sae as tsae
from semanticlens_tpu_torch.models import ResNet as TResNet
from semanticlens_tpu_torch.models.base import SubjectModel as TSubject
from semanticlens_tpu_torch.models.base import TapCollector as TTap
from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean as t_mean
from semanticlens_tpu_torch.ops.aggregators import aggregate_transformer_mean as t_tmean

torch.set_num_threads(2)

IMG = 16
FAST = dict(steps=48, lr=0.1, jitter=2, tv=0.0, l2=1e-4)
_W = np.random.default_rng(0)
TINY_W = {"0.weight": (_W.normal(size=(3, 3, 3, 8)) * 0.2).astype(np.float32),
          "1.weight": (_W.normal(size=(3, 3, 8, 6)) * 0.2).astype(np.float32)}


class JTiny(JSubject):
    module_names = ("0", "1")

    def apply(self, params, x, tap_names=()):
        tap = JTap(tap_names)
        x = tap("0", jax.nn.relu(jconv2d(x, params["0.weight"], padding=1)))
        x = tap("1", jconv2d(x, params["1.weight"], padding=1))
        return x, tap.taps


class TTiny(TSubject):
    """The same two convs in torch (NCHW inside, NHWC taps)."""

    module_names = ("0", "1")
    device = torch.device("cpu")

    def apply(self, params, x, tap_names=()):
        tap = TTap(tap_names, channels_first=True)
        x = tap("0", torch.relu(F.conv2d(x.permute(0, 3, 1, 2), params["0.weight"], padding=1)))
        x = tap("1", F.conv2d(x, params["1.weight"], padding=1))
        return x.permute(0, 2, 3, 1), {k: v.permute(0, 2, 3, 1) for k, v in tap.taps.items()}


class TTokens(TSubject):
    """(B, H, W, 3) → (B, T, 5) tokens: the transformer aggregators' case."""

    module_names = ("proj",)
    device = torch.device("cpu")

    def apply(self, params, x, tap_names=()):
        tap = TTap(tap_names)
        tokens = tap("proj", torch.tanh(x.reshape(x.shape[0], -1, 3) @ params["w"]))
        return tokens, tap.taps


def tiny_pair():
    """(JAX model, port model), the same weights, named ``tiny-synth``."""
    jmodel, tmodel = JTiny(), TTiny()
    jmodel.params = {k: jnp.asarray(v) for k, v in TINY_W.items()}
    tmodel.params = {k: torch.from_numpy(np.ascontiguousarray(v.transpose(3, 2, 0, 1))) for k, v in TINY_W.items()}
    jmodel.name = tmodel.name = "tiny-synth"
    return jmodel, tmodel


def _preprocess(x):
    return x / 255.0


def jax_stream(cfg, k, image_size, seed):
    """z0 and the per-step draws of the JAX loop (``featviz.py:146-171``) from its keys."""
    kinit, kloop = jax.random.split(jax.random.PRNGKey(seed))
    canvas = image_size + 2 * cfg.jitter
    z0 = np.asarray(cfg.init_scale * jax.random.normal(kinit, (k, canvas, canvas, 3), jnp.float32))
    offsets, flips = [], []
    for step_key in jax.random.split(kloop, cfg.steps):
        if cfg.jitter > 0:
            kh, kw, kf = jax.random.split(step_key, 3)
            offsets.append([int(jax.random.randint(kh, (), 0, 2 * cfg.jitter + 1)),
                            int(jax.random.randint(kw, (), 0, 2 * cfg.jitter + 1))])
        else:
            kf = step_key
            offsets.append([0, 0])
        flips.append(np.asarray(jax.random.bernoulli(kf, shape=(k, 1, 1, 1))).reshape(k) if cfg.flip
                     else np.zeros(k, bool))
    return z0, torch.tensor(offsets, dtype=torch.int64), torch.from_numpy(np.stack(flips))


def inject(monkeypatch, stream):
    z0, offsets, flips = stream
    monkeypatch.setattr(tfv, "_init_canvas", lambda cfg, k, canvas_hw, generator: torch.from_numpy(z0.copy()))
    monkeypatch.setattr(tfv, "_draws", lambda cfg, k, generator: (offsets, flips))


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max |Δ| {err:.3g} > {tol:.3g}"


# ------------------------------------------------------------------ Adam
@pytest.mark.parametrize("which", ["adam", "clip_adam"])
def test_adam_matches_optax(which):
    """Three steps of ``sae.Adam`` against ``optax.adam`` (the featviz optimizer, no clip), and of
    ``ClipAdam`` against optax's clipped chain on the same gradients (global norm above 1)."""
    rng = np.random.default_rng(0)
    p = {"z": rng.normal(size=(2, 5, 5, 3)).astype(np.float32), "b": rng.normal(size=(7,)).astype(np.float32)}
    tx = optax.adam(0.05) if which == "adam" else optax.chain(optax.clip_by_global_norm(1.0), optax.adam(0.05))
    opt = tsae.Adam(0.05) if which == "adam" else tsae.ClipAdam(0.05)
    jp, tp = {n: jnp.asarray(v) for n, v in p.items()}, {n: torch.from_numpy(v) for n, v in p.items()}
    jstate, tstate = tx.init(jp), opt.init(tp)
    for _ in range(3):
        g = {n: (3.0 * rng.normal(size=v.shape)).astype(np.float32) for n, v in p.items()}
        ju, jstate = tx.update({n: jnp.asarray(v) for n, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = opt.update({n: torch.from_numpy(v) for n, v in g.items()}, tstate)
        tp = tsae.apply_updates(tp, tu)
        for n in p:
            _close(tu[n].numpy(), ju[n], 2e-6 * float(np.abs(np.asarray(ju[n])).max()), f"update {n}")
            _close(tp[n].numpy(), jp[n], 2e-6 * float(np.abs(np.asarray(jp[n])).max()), n)
    assert tstate["count"] == 3 and isinstance(opt, tsae.Adam)


# ------------------------------------------------------------------ loss pieces
def test_total_variation_and_loss_match_jax():
    jmodel, tmodel = tiny_pair()
    cfg = tfv.SynthesisConfig(**FAST)
    img = np.random.default_rng(2).random((3, IMG, IMG, 3)).astype(np.float32)
    _close(tfv._total_variation(torch.from_numpy(img)).numpy(), jfv._total_variation(jnp.asarray(img)), 1e-6, "TV")
    ids, z = [0, 3, 5], np.random.default_rng(3).normal(size=(3, IMG + 4, IMG + 4, 3)).astype(np.float32)
    offset, flip = (1, 3), np.array([True, False, True])
    loss, obj = tfv._loss(tmodel, tmodel.params, "0", t_mean, _preprocess, cfg, IMG, torch.from_numpy(z),
                          torch.tensor(ids), offset, torch.from_numpy(flip))
    # the JAX loss (featviz.py:143-160) on the same window and flips, from the JAX package's own pieces
    jimg = jax.nn.sigmoid(jnp.asarray(z))[:, 1 : 1 + IMG, 3 : 3 + IMG, :]
    jimg = jnp.where(jnp.asarray(flip)[:, None, None, None], jimg[:, :, ::-1, :], jimg)
    _, taps = jmodel.apply(jmodel.params, _preprocess(jimg * 255.0), ("0",))
    jobj = jfv._agg_component(taps["0"], jnp.asarray(ids), j_mean)
    reg = cfg.l2 * jnp.mean((jimg - 0.5) ** 2, axis=(1, 2, 3)) + cfg.tv * jfv._total_variation(jimg)
    _close(loss.item(), jnp.mean(reg - jobj), 1e-6, "loss")
    _close(obj.item(), jnp.mean(jobj), 1e-6, "mean objective")
    with pytest.raises(ValueError, match="batch, components"):
        tfv._agg_component(torch.zeros(2, 4, 4, 3), torch.tensor([0, 1]), lambda t: t)


# ------------------------------------------------------------------ synthesize
@pytest.mark.parametrize("steps,jitter,flip", [(6, 2, True), (5, 0, False), (4, 3, True)])
def test_synthesize_matches_the_jax_host_loop_on_injected_draws(monkeypatch, steps, jitter, flip):
    jmodel, tmodel = tiny_pair()
    kw = dict(steps=steps, lr=0.1, jitter=jitter, flip=flip, tv=2.5e-4, l2=1e-3)
    ids = [0, 3, 5, 5]
    jimg, jobj, jtrace = jfv.synthesize(jmodel, jmodel.params, "0", ids, j_mean, image_size=IMG,
                                        model_preprocess=_preprocess, config=jfv.SynthesisConfig(**kw), seed=4,
                                        return_trace=True)
    inject(monkeypatch, jax_stream(tfv.SynthesisConfig(**kw), len(ids), IMG, 4))
    timg, tobj, ttrace = tfv.synthesize(tmodel, tmodel.params, "0", ids, t_mean, image_size=IMG,
                                        model_preprocess=_preprocess, config=tfv.SynthesisConfig(**kw), seed=4,
                                        return_trace=True)
    assert timg.shape == (4, IMG, IMG, 3) and timg.dtype == np.float32
    _close(timg, jimg, 1e-5, "images")
    _close(tobj, jobj, 1e-5 * max(1.0, float(np.abs(jobj).max())), "objective")
    _close(ttrace, jtrace, 1e-5 * max(1.0, float(np.abs(jtrace).max())), "trace")


def test_resnet_synthesis_matches_jax_on_injected_draws(monkeypatch):
    """ResNet-18 at 32²: images within 1e-4. Adam's first steps move z by ``lr·g / (|g| + 1e-8)``, and
    some input gradients here sit near 1e-8 (median 1.1e-4, max 1.7e-3), so a float32 difference δ in
    such a g moves z by up to ``lr·δ / 4e-8``: the two packages' conv sums then part by ~1.6e-5 after
    three steps, where the two-conv model stays under 1e-5."""
    tmodel = TResNet(depth=18, num_classes=10, dtype=torch.float32, device="cpu")
    npp = tmodel.init_jax_layout(0)
    tmodel.params = tmodel.load_jax_params(npp)
    jmodel = JResNet(depth=18, num_classes=10, dtype=jnp.float32)
    jmodel.params = {k: jnp.asarray(v) for k, v in npp.items()}
    kw = dict(steps=3, jitter=2)
    jimg, jobj = jfv.synthesize(jmodel, jmodel.params, "layer2", [1, 7], j_mean, image_size=32,
                                model_preprocess=_preprocess, config=jfv.SynthesisConfig(**kw), seed=0)
    inject(monkeypatch, jax_stream(tfv.SynthesisConfig(**kw), 2, 32, 0))
    timg, tobj = tfv.synthesize(tmodel, tmodel.params, "layer2", [1, 7], t_mean, image_size=32,
                                model_preprocess=_preprocess, config=tfv.SynthesisConfig(**kw), seed=0)
    _close(timg, jimg, 1e-4, "images")
    _close(tobj, jobj, 1e-4 * float(np.abs(jobj).max()), "objective")
    assert all(p.grad is None and not p.requires_grad for p in tmodel.params.values())  # only z ascends


def test_scan_loop_bit_equals_host_and_seed_decides():
    _, tmodel = tiny_pair()
    kw = dict(image_size=IMG, model_preprocess=_preprocess, config=tfv.SynthesisConfig(**FAST))
    a = tfv.synthesize(tmodel, tmodel.params, "0", [0, 2], t_mean, seed=3, loop="scan")
    b = tfv.synthesize(tmodel, tmodel.params, "0", [0, 2], t_mean, seed=3, loop="host")
    c = tfv.synthesize(tmodel, tmodel.params, "0", [0, 2], t_mean, seed=3)
    d = tfv.synthesize(tmodel, tmodel.params, "0", [0, 2], t_mean, seed=4)
    for x, y in ((a, b), (b, c)):
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[1], y[1])
    assert not np.array_equal(c[0], d[0])
    assert tfv.clear_programs() is None and tfv.__all__ == jfv.__all__


def test_synthesize_ascends_and_stays_in_range():
    """The JAX tests' behaviour: the objective beats random noise, the trace rises, images in [0, 1]."""
    _, tmodel = tiny_pair()
    ids = [0, 3, 5]
    images, objective, trace = tfv.synthesize(tmodel, tmodel.params, "0", ids, t_mean, image_size=IMG,
                                              model_preprocess=_preprocess, config=tfv.SynthesisConfig(**FAST),
                                              return_trace=True)
    assert images.shape == (3, IMG, IMG, 3) and images.min() >= 0.0 and images.max() <= 1.0
    noise = torch.from_numpy(np.random.default_rng(0).uniform(size=(3, IMG, IMG, 3)).astype(np.float32))
    _, taps = tmodel.apply(tmodel.params, noise, ("0",))
    base = t_mean(taps["0"]).numpy()[np.arange(3), ids]
    assert (objective > base + 1e-3).all(), (objective, base)
    assert trace.shape == (FAST["steps"],) and trace[-8:].mean() > trace[:8].mean()


def test_synthesize_on_token_taps():
    model = TTokens()
    model.params = {"w": torch.from_numpy(np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32))}
    images, objective = tfv.synthesize(model, model.params, "proj", [0, 4], t_tmean, image_size=8,
                                       model_preprocess=_preprocess, config=tfv.SynthesisConfig(**FAST))
    assert images.shape == (2, 8, 8, 3) and np.isfinite(objective).all()


@pytest.mark.parametrize("kwargs,error,match", [
    ({"loop": "nope"}, ValueError, "scan.*host"),
    ({"mesh": object()}, TypeError, "DeviceMesh"),
    ({"component_ids": [[0]]}, ValueError, "1-D"),
], ids=["loop", "mesh", "ids"])
def test_synthesize_rejects(kwargs, error, match):
    _, tmodel = tiny_pair()
    call = dict(component_ids=[0], image_size=IMG, model_preprocess=_preprocess,
                config=tfv.SynthesisConfig(**FAST)) | kwargs
    with pytest.raises(error, match=match):
        tfv.synthesize(tmodel, tmodel.params, "0", aggregate_fn=t_mean, **call)
