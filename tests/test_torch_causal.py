"""``semanticlens_tpu_torch.causal`` against ``semanticlens_tpu.causal`` on the same weights.

The cases of JAX ``tests/test_causal.py``: a two-layer linear tap model
(every intervention checkable in closed form) and ResNet-18 at 32², the
same numpy weights and images in both packages, float32 on the CPU. Each of
the five functions is held to the JAX one within 1e-5 of the largest |Δ|
(ResNet-18: 1e-4, float32 convolutions summed in another order). The port's
one forward over K·B rows, chunked, equals K single forwards. The
``causal_audit`` entry point has the JAX tool's flags and JSON keys.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semanticlens_tpu import causal as jcausal
from semanticlens_tpu import sae as jsae
from semanticlens_tpu.models import base as jbase
from semanticlens_tpu.models.resnet import ResNet as JResNet
from semanticlens_tpu_torch import causal as tcausal
from semanticlens_tpu_torch import causal_audit, convert
from semanticlens_tpu_torch.models import ResNet as TResNet
from semanticlens_tpu_torch.models import base as tbase

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RNG = np.random.default_rng(0)
W1, W2 = RNG.normal(size=(6, 4)).astype(np.float32), RNG.normal(size=(4, 3)).astype(np.float32)
X = RNG.normal(size=(5, 6)).astype(np.float32)
Y = RNG.normal(size=(5, 6)).astype(np.float32)
IMAGES = np.random.default_rng(1).random((3, 32, 32, 3)).astype(np.float32)


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


JLIN = (JLinear(), {"w1": jnp.asarray(W1), "w2": jnp.asarray(W2)})
TLIN = (TLinear(), {"w1": torch.from_numpy(W1), "w2": torch.from_numpy(W2)})


def _close(got, want, rel=1e-5, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, f"{what}: max |Δ| {err:.3g} > {rel} × {scale:.3g}"


@pytest.fixture(scope="module")
def resnets():
    tmodel = TResNet(depth=18, num_classes=7, dtype=torch.float32, device="cpu")
    npp = tmodel.init_jax_layout(0)
    rng = np.random.default_rng(5)
    for name in npp:  # non-trivial BN statistics and biases
        if npp[name].ndim == 1:
            npp[name] = npp[name] + rng.uniform(0.0, 0.2, size=npp[name].shape).astype(np.float32)
    tmodel.params = tmodel.load_jax_params(npp)
    jmodel = JResNet(depth=18, num_classes=7, dtype=jnp.float32)
    jmodel.params = {k: jnp.asarray(v) for k, v in npp.items()}
    return jmodel, tmodel


# ------------------------------------------------------------------ ablation
@pytest.mark.parametrize("mode", ["zero", "mean"])
@pytest.mark.parametrize("target_class", [None, 1])
def test_ablation_effects_match_jax_and_closed_form(mode, target_class):
    ids = [0, 2, 3]
    want = jcausal.ablation_effects(*JLIN, "hidden", jnp.asarray(X), ids, mode=mode,
                                    target_class=target_class)
    got = tcausal.ablation_effects(*TLIN, "hidden", X, ids, mode=mode, target_class=target_class)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5, f"{mode} / {target_class}")
    h = X @ W1
    fill = h.mean(0) if mode == "mean" else np.zeros(4, np.float32)
    closed = np.stack([(h[:, c : c + 1] - fill[c]) * W2[c][None, :] for c in ids])
    _close(got, closed if target_class is None else closed[..., target_class], 1e-5, "closed form")


@pytest.mark.parametrize("mode", ["zero", "mean"])
def test_resnet_ablation_matches_jax(resnets, mode):
    jmodel, tmodel = resnets
    ids = [0, 5, 17, 100]
    want = jcausal.ablation_effects(jmodel, jmodel.params, "layer2", jnp.asarray(IMAGES), ids, mode=mode)
    got = tcausal.ablation_effects(tmodel, tmodel.params, "layer2", IMAGES, ids, mode=mode)
    assert got.shape == (4, 3, 7) and np.abs(np.asarray(want)).sum() > 0
    _close(got, want, 1e-4, mode)


def test_batched_rows_equal_single_forwards(resnets, monkeypatch):
    """One forward over K·B rows, chunked mid-way through a mask's images, equals K forwards of one mask."""
    _, tmodel = resnets
    ids = [3, 9, 40, 127]
    monkeypatch.setattr(tcausal, "ROWS_PER_FORWARD", 5)  # 12 rows in chunks of 5, 5, 2
    batched = tcausal.ablation_effects(tmodel, tmodel.params, "layer3", IMAGES, ids, mode="mean")
    monkeypatch.setattr(tcausal, "ROWS_PER_FORWARD", 512)
    whole = tcausal.ablation_effects(tmodel, tmodel.params, "layer3", IMAGES, ids, mode="mean")
    single = torch.cat([tcausal.ablation_effects(tmodel, tmodel.params, "layer3", IMAGES, [c], mode="mean")
                        for c in ids])
    _close(batched, single, 1e-6, "chunked vs single")
    _close(whole, single, 1e-6, "one forward vs single")


# ------------------------------------------------------------------ patching, steering
@pytest.mark.parametrize("component_ids", [None, [1, 3]], ids=["whole-layer", "components"])
def test_activation_patch_matches_jax(component_ids):
    jp, jc = jcausal.activation_patch(*JLIN, "hidden", jnp.asarray(X), jnp.asarray(Y), component_ids)
    tp, tc = tcausal.activation_patch(*TLIN, "hidden", X, Y, component_ids)
    _close(tp, jp, 1e-5, "patched")
    _close(tc, jc, 1e-5, "clean")
    hx, hy = (X @ W1).copy(), Y @ W1
    cols = slice(None) if component_ids is None else component_ids
    hx[:, cols] = hy[:, cols]
    _close(tp, hx @ W2, 1e-5, "closed form")


def test_activation_patch_whole_resnet_layer_gives_the_source_logits(resnets):
    jmodel, tmodel = resnets
    src = np.random.default_rng(7).random((3, 32, 32, 3)).astype(np.float32)
    jp, _ = jcausal.activation_patch(jmodel, jmodel.params, "layer3", jnp.asarray(IMAGES), jnp.asarray(src))
    tp, _ = tcausal.activation_patch(tmodel, tmodel.params, "layer3", IMAGES, src)
    _close(tp, jp, 1e-4, "patched")
    _close(tp, tmodel.apply(tmodel.params, torch.from_numpy(src))[0], 1e-5, "source logits")
    with pytest.raises(ValueError, match="align 1:1"):
        tcausal.activation_patch(tmodel, tmodel.params, "layer3", IMAGES, src[:2])


@pytest.mark.parametrize("alpha", [0.0, 2.5])
def test_steer_matches_jax(alpha):
    direction = np.zeros(4, np.float32)
    direction[2] = 1.0
    want = jcausal.steer(*JLIN, "hidden", jnp.asarray(X), direction, alpha=alpha)
    got = tcausal.steer(*TLIN, "hidden", X, direction, alpha=alpha)
    _close(got, want, 1e-5)
    _close(got, X @ W1 @ W2 + alpha * W2[2][None, :], 1e-5, "closed form")


def test_resnet_steer_matches_jax(resnets):
    jmodel, tmodel = resnets
    direction = np.random.default_rng(3).normal(size=256).astype(np.float32)
    want = jcausal.steer(jmodel, jmodel.params, "layer3", jnp.asarray(IMAGES), direction, alpha=0.5)
    got = tcausal.steer(tmodel, tmodel.params, "layer3", IMAGES, direction, alpha=0.5)
    _close(got, want, 1e-4)


# ------------------------------------------------------------------ necessity ratio
def test_necessity_ratio_separates_causal_from_dead_as_jax():
    ev = np.tile(W1[:, 0] / np.linalg.norm(W1[:, 0]), (4, 1)).astype(np.float32) * 3
    ct = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32)
    ct -= np.outer(ct @ W1[:, 0], W1[:, 0] / (W1[:, 0] ** 2).sum())
    want = jcausal.necessity_ratio(*JLIN, "hidden", [0, 1], jnp.asarray(ev), jnp.asarray(ct))
    got = tcausal.necessity_ratio(*TLIN, "hidden", [0, 1], ev, ct)
    assert got.shape == (2,) and float(got[0]) > 10.0
    _close(got[1:], want[1:], 1e-5, "ratio")  # component 0's control Δ is ~0: the ratio is ill-conditioned
    assert float(got[0]) > 10.0 and float(want[0]) > 10.0


def test_resnet_necessity_ratio_matches_jax(resnets):
    jmodel, tmodel = resnets
    ev, ct = IMAGES[:2], np.random.default_rng(9).random((2, 32, 32, 3)).astype(np.float32)
    want = jcausal.necessity_ratio(jmodel, jmodel.params, "layer3", [1, 2, 3], jnp.asarray(ev), jnp.asarray(ct))
    got = tcausal.necessity_ratio(tmodel, tmodel.params, "layer3", [1, 2, 3], ev, ct)
    _close(got, want, 1e-4, "ratios")


# ------------------------------------------------------------------ SAE latents
def _sae(bare=False):
    cfg = jsae.SAEConfig(d_in=4, n_latents=10, k=3)
    raw = jsae.init_sae(jax.random.PRNGKey(7), cfg)
    jp = raw if bare else jsae.finalize_sae_params(raw, cfg)
    return jp, convert.sae_params_from_jax({n: np.asarray(v) for n, v in jp.items()}, device="cpu")


@pytest.mark.parametrize("substitute_clean", [False, True])
def test_sae_latent_ablation_matches_jax(substitute_clean):
    jp, tp = _sae()
    want = jcausal.sae_latent_ablation(*JLIN, "hidden", jp, jnp.asarray(X), [2, 7],
                                       substitute_clean=substitute_clean)
    got = tcausal.sae_latent_ablation(*TLIN, "hidden", tp, X, [2, 7], substitute_clean=substitute_clean)
    assert got.shape == (2, 5, 3)
    _close(got, want, 1e-5, "Δ")
    if not substitute_clean:  # closed form: the baseline and the ablation differ by latent f's decode row
        z = jsae.encode(jp, jnp.asarray(X @ W1), k=3)
        for j, f in enumerate([2, 7]):
            want_f = np.asarray(z)[:, f : f + 1] * (np.asarray(jp["W_dec"])[f] @ W2)[None, :]
            _close(got[j], want_f, 1e-4, f"latent {f}")


def test_resnet_sae_latent_ablation_matches_jax(resnets):
    jmodel, tmodel = resnets
    cfg = jsae.SAEConfig(d_in=256, n_latents=32, k=4)
    jp = jsae.finalize_sae_params(jsae.init_sae(jax.random.PRNGKey(2), cfg), cfg)
    tp = convert.sae_params_from_jax({n: np.asarray(v) for n, v in jp.items()}, device="cpu")
    want = jcausal.sae_latent_ablation(jmodel, jmodel.params, "layer3", jp, jnp.asarray(IMAGES), [0, 5, 31])
    got = tcausal.sae_latent_ablation(tmodel, tmodel.params, "layer3", tp, IMAGES, [0, 5, 31])
    _close(got, want, 1e-4, "Δ")


# ------------------------------------------------------------------ validation
def _sp():
    return _sae()[1]


ERRORS = [
    ("layer", lambda: tcausal.ablation_effects(*TLIN, "nope", X, [0]), "not found"),
    ("2-D ids", lambda: tcausal.ablation_effects(*TLIN, "hidden", X, [[0]]), "1-D"),
    ("mode", lambda: tcausal.ablation_effects(*TLIN, "hidden", X, [0], mode="drop"), "zero"),
    ("id = width", lambda: tcausal.ablation_effects(*TLIN, "hidden", X, [4]), "out of range"),
    ("negative id", lambda: tcausal.ablation_effects(*TLIN, "hidden", X, [-1]), "out of range"),
    ("patch id", lambda: tcausal.activation_patch(*TLIN, "hidden", X, X, [7]), "out of range"),
    ("latent id", lambda: tcausal.sae_latent_ablation(*TLIN, "hidden", _sp(), X, [10]), "out of range"),
    ("bare dictionary", lambda: tcausal.sae_latent_ablation(*TLIN, "hidden", _sae(bare=True)[1], X, [0]),
     "sparsity unknown"),
    ("steer layer", lambda: tcausal.steer(*TLIN, "nope", X, np.zeros(4)), "not found"),
]


@pytest.mark.parametrize("case,call,match", ERRORS, ids=[e[0] for e in ERRORS])
def test_validation_errors(case, call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_clear_programs_and_all_match_jax():
    assert tcausal.__all__ == jcausal.__all__
    assert tcausal.clear_programs() is None  # nothing memoized to drop
    a = tcausal.ablation_effects(*TLIN, "hidden", X, [0, 1])
    tcausal.clear_programs()
    assert torch.equal(a, tcausal.ablation_effects(*TLIN, "hidden", X, [0, 1]))


# ------------------------------------------------------------------ the entry point
def _jax_tool():
    return ast.parse((REPO / "tools" / "causal_audit.py").read_text())


def test_causal_audit_flags_and_defaults_are_the_jax_tools():
    flags = {}
    for node in ast.walk(_jax_tool()):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            flags[node.args[0].value] = next(
                (ast.literal_eval(k.value) for k in node.keywords if k.arg == "default"), False)
    args = vars(causal_audit.parse_args([]))
    assert {f"--{k.replace('_', '-')}" for k in args} == set(flags)
    for flag, default in flags.items():
        assert args[flag[2:].replace("-", "_")] == default, flag
    with pytest.raises(SystemExit, match="unknown arch"):
        causal_audit.main(["--cpu", "--arch", "swin_v3"])


def test_causal_audit_cli_reports_the_jax_keys():
    dumps = sorted((node for node in ast.walk(_jax_tool())
                    if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                    and node.args and isinstance(node.args[0], ast.Dict)), key=lambda node: node.lineno)
    keys = [[k.value for k in node.args[0].keys] for node in dumps]  # per component, then the summary
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "semanticlens_tpu_torch.causal_audit", "--cpu", "--images", "16",
                           "--image-size", "32", "--components", "3", "--evidence", "2", "--batch", "8"],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    assert [list(line) for line in lines] == [keys[0]] * 3 + [keys[1]]
    assert list(causal_audit.REPORT_KEYS) == keys[1]
    summary = lines[-1]
    assert summary["components"] == 3 and summary["device"] == "cpu" and summary["layer"] == "layer3"
    assert all(np.isfinite(line["necessity_ratio"]) and line["necessity_ratio"] > 0 for line in lines[:3])
