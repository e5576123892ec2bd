"""Port parity: the SAE and transcoder trainers against the JAX package.

``train_sae_from_rows`` draws its minibatch indices from the JAX trainer's
host numpy stream, so from the same initial parameters the two trainers
take the same rows in the same order: the index stream is compared
exactly, ``stats`` (``last_fired``, ``step``) exactly, and parameters and
metrics after 10 steps within 1e-5 of the largest magnitude (float32 sums in
another order, compounded by Adam; the largest difference measured over the
four cases was 3.2e-7). The streaming trainers draw positions and permutations from a
``torch.Generator`` where the JAX ones use ``jax.random``: their rows at
``positions_per_image=0`` equal the JAX extractor's exactly, and their final
fvu is held to the JAX trainer's on the same data within a bound set from
readings over five seeds (given at each test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semanticlens_tpu import sae as jsae
from semanticlens_tpu.data import ArrayDataset as JDS
from semanticlens_tpu.models.base import TapCollector as JTap
from semanticlens_tpu_torch import sae as tsae
from semanticlens_tpu_torch.data import ArrayDataset as TDS
from semanticlens_tpu_torch.models.base import SubjectModel, TapCollector

torch.set_num_threads(2)


def _planted_dictionary(d_in=16, f_true=24, k_true=3, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    atoms = rng.normal(size=(f_true, d_in))
    atoms /= np.linalg.norm(atoms, axis=1, keepdims=True)
    codes = np.zeros((n, f_true), np.float32)
    for i in range(n):
        codes[i, rng.choice(f_true, k_true, replace=False)] = rng.uniform(0.5, 2.0, k_true)
    x = codes @ atoms + 0.01 * rng.normal(size=(n, d_in))
    return atoms, x.astype(np.float32)


def _recovery(atoms, w_dec):
    w = np.asarray(w_dec)
    w = w / np.linalg.norm(w, axis=1, keepdims=True)
    return np.abs(atoms @ w.T).max(axis=1)


def _close(got, want, rel, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max |Δ| {err:.3g} > {rel} × {scale:.3g}"


def _record_batches(monkeypatch):
    """Capture every minibatch block both trainers step through (the gathered rows)."""
    seen = {"jax": [], "port": []}
    j_scan, t_run = jsae._scan_steps, tsae._run_steps

    def j_recording(cfg, optimizer, paired=False):
        run = j_scan(cfg, optimizer, paired)

        def wrapped(p, o, s, batches):
            seen["jax"].append(np.asarray(batches[0] if paired else batches))
            return run(p, o, s, batches)

        return wrapped

    def t_recording(cfg, optimizer, paired=False, **kwargs):
        run = t_run(cfg, optimizer, paired, **kwargs)

        def wrapped(p, o, s, batches):
            seen["port"].append((batches[0] if paired else batches).numpy().copy())
            return run(p, o, s, batches)

        return wrapped

    monkeypatch.setattr(jsae, "_scan_steps", j_recording)
    monkeypatch.setattr(tsae, "_run_steps", t_recording)
    return seen


TRAIN_CASES = {
    "topk_auxk": {"k": 2, "n_latents": 256, "aux_k": 12, "dead_steps": 2},
    "relu_l1": {"k": 0, "l1_coef": 1e-2},
    "jumprelu": {"k": 0, "jumprelu": True, "init_theta": 0.05, "ste_eps": 0.05, "l0_coef": 1e-2},
    "skip_transcoder": {"k": 4, "d_out": 6, "skip": True},
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_from_rows_matches_jax_for_10_steps(case, monkeypatch):
    kw = {"d_in": 10, "n_latents": 48, "lr": 3e-3, "batch_rows": 64, "seed": 3, **TRAIN_CASES[case]}
    jcfg, tcfg = jsae.SAEConfig(**kw), tsae.SAEConfig(**kw)
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(200, 10)).astype(np.float32)  # 10 × 64 rows: the permutation wraps three times
    targets = np.tanh(rows @ rng.normal(size=(10, 6))).astype(np.float32) if jcfg.is_transcoder else None
    init = {n: np.asarray(v) for n, v in jsae.init_sae(jax.random.PRNGKey(5), jcfg).items()}
    if jcfg.is_transcoder:
        init = {n: np.asarray(v) for n, v in jsae._calibrate_transcoder_init(init, rows, targets).items()}
    seen = _record_batches(monkeypatch)
    jp, jstats, jm = jsae.train_sae_from_rows(rows, jcfg, targets=targets, steps=10, params=init)
    tp, tstats, tm = tsae.train_sae_from_rows(rows, tcfg, targets=targets, steps=10, params=init, device="cpu")
    assert len(seen["jax"]) == len(seen["port"]) == 1
    np.testing.assert_array_equal(seen["port"][0], seen["jax"][0])  # the same rows in the same order
    assert tp["k"] == int(jp["k"]) == kw["k"] and set(tp) == set(jp)
    for n in jp:
        if n != "k":
            _close(tp[n], jp[n], 1e-5, n)
    for n in jm:
        _close(tm[n], jm[n], 1e-5, n)
    assert int(tstats["step"]) == int(jstats["step"]) == 10
    np.testing.assert_array_equal(tstats["last_fired"].numpy(), np.asarray(jstats["last_fired"]))
    if case == "topk_auxk":
        assert int((tstats["last_fired"] >= 2).sum()) > 0  # AuxK had dead latents to revive
    if case == "relu_l1":
        torch.testing.assert_close(torch.linalg.vector_norm(tp["W_dec"], dim=1), torch.ones(kw["n_latents"]))


def test_transcoder_init_calibration_uses_population_std():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 5)).astype(np.float32)
    y = (3.0 * rng.normal(size=(50, 4)) + 1.0).astype(np.float32)
    kw = {"d_in": 5, "n_latents": 8, "d_out": 4}
    init = {n: np.asarray(v) for n, v in jsae.init_sae(jax.random.PRNGKey(0), jsae.SAEConfig(**kw)).items()}
    want = jsae._calibrate_transcoder_init(init, x, y)
    got = tsae._calibrate_transcoder_init({n: torch.from_numpy(v) for n, v in init.items()},
                                          torch.from_numpy(x), torch.from_numpy(y))
    for n in want:
        _close(got[n], want[n], 1e-6, n)
    sample_std = np.asarray(init["W_dec"]) * np.std(y, ddof=1)
    assert not np.allclose(got["W_dec"].numpy(), sample_std, rtol=1e-4, atol=0)


def test_epoch_permutation_visits_every_row(monkeypatch):
    n = 96
    cfg = tsae.SAEConfig(d_in=n, n_latents=4, k=1, batch_rows=32, seed=1)
    seen = _record_batches(monkeypatch)
    tsae.train_sae_from_rows(np.eye(n, dtype=np.float32), cfg, steps=3, device="cpu")  # 3 · 32 = one epoch
    assert sorted(seen["port"][0].argmax(-1).ravel().tolist()) == list(range(n))


def test_topk_recovers_planted_dictionary_and_is_deterministic():
    atoms, x = _planted_dictionary()
    cfg = tsae.SAEConfig(d_in=16, n_latents=32, k=3, lr=2e-3, batch_rows=512, seed=1)
    params, stats, metrics = tsae.train_sae_from_rows(x, cfg, steps=800, device="cpu")
    assert metrics["fvu"] < 0.1 and metrics["l0"] == 3.0
    best = _recovery(atoms, params["W_dec"].numpy())
    assert best.mean() > 0.95 and best.min() > 0.9
    again, _, _ = tsae.train_sae_from_rows(x, cfg, steps=800, device="cpu")
    assert torch.equal(again["W_dec"], params["W_dec"])
    resumed, _, _ = tsae.train_sae_from_rows(x, cfg, steps=2, params=params, device="cpu")
    assert resumed["k"] == 3


def test_relu_l1_trains_sparse_with_unit_decoder():
    _, x = _planted_dictionary()
    cfg = tsae.SAEConfig(d_in=16, n_latents=32, k=0, l1_coef=1e-2, lr=2e-3, batch_rows=512, seed=0)
    params, _, metrics = tsae.train_sae_from_rows(x, cfg, steps=600, device="cpu")
    assert metrics["fvu"] < 0.05 and metrics["l0"] < 0.9 * cfg.n_latents
    torch.testing.assert_close(torch.linalg.vector_norm(params["W_dec"], dim=1), torch.ones(32), rtol=1e-5, atol=0)


def test_step_tracks_firing_and_reads_nothing_back():
    cfg = tsae.SAEConfig(d_in=8, n_latents=16, k=2, batch_rows=32)
    params = tsae.init_sae(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = tsae.make_optimizer(cfg)
    step = tsae.make_train_step(cfg, opt)
    x = torch.randn(32, 8, generator=torch.Generator().manual_seed(1))
    params, state, stats, metrics = step(params, opt.init(params), tsae.init_stats(cfg, device="cpu"), x)
    assert int(stats["step"]) == 1 and state["count"] == 1
    lf = stats["last_fired"]
    assert lf.dtype == torch.int32 and (lf == 0).any() and set(lf.unique().tolist()) <= {0, 1}
    assert all(isinstance(v, torch.Tensor) and v.shape == () for v in metrics.values())
    assert not any(p.requires_grad for p in params.values())


def test_log_every_reports_metrics(caplog):
    _, x = _planted_dictionary(n=512)
    cfg = tsae.SAEConfig(d_in=16, n_latents=16, k=3, batch_rows=128)
    with caplog.at_level("INFO", logger="semanticlens_tpu_torch.sae"):
        tsae.train_sae_from_rows(x, cfg, steps=40, log_every=32, device="cpu")
    # the JAX trainer's rule: after each chunk of 32 steps whose end passes a multiple of log_every
    assert [r.getMessage().split(":")[0] for r in caplog.records] == ["sae step 32", "sae step 40"]


def test_error_paths():
    cfg = tsae.SAEConfig(d_in=16, n_latents=8, k=2, batch_rows=64)
    with pytest.raises(ValueError, match="rows must be"):
        tsae.train_sae_from_rows(np.zeros((100, 4), np.float32), cfg, steps=1, device="cpu")
    with pytest.raises(ValueError, match="batch_rows"):
        tsae.train_sae_from_rows(np.zeros((32, 16), np.float32), cfg, steps=1, device="cpu")
    with pytest.raises(ValueError, match="pairs"):
        tsae.train_sae_from_rows(np.zeros((64, 16), np.float32), cfg, targets=np.zeros((64, 2)), device="cpu")
    tc = tsae.SAEConfig(d_in=16, n_latents=8, k=2, batch_rows=64, d_out=3)
    with pytest.raises(ValueError, match="targets must be"):
        tsae.train_transcoder_from_rows(np.zeros((64, 16), np.float32), np.zeros((64, 2)), tc, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsae.train_sae_from_rows(np.zeros((64, 16), np.float32), cfg, mesh=object(), device="cpu")
    model = _PortTaps()
    with pytest.raises(ValueError, match="batch_size"):
        tsae.train_sae_on_layer(model, {}, TDS(np.zeros((4, 6, 6, 3), np.float32)), "a", cfg, batch_size=8)
    big = tsae.SAEConfig(d_in=6, n_latents=8, k=2, batch_rows=10_000)
    with pytest.raises(ValueError, match="rows <"):
        tsae.train_sae_on_layer(model, {}, TDS(np.zeros((16, 6, 6, 3), np.float32)), "a", big, batch_size=8)
    with pytest.raises(ValueError, match="d_out"):
        tsae.train_transcoder_on_layer(model, {}, TDS(np.zeros((16, 6, 6, 3), np.float32)), "a", "b", big)


# ------------------------------------------------------------------ streaming
class _JaxTaps:
    """Two positionally aligned taps from exact elementwise maps: ``a`` (B, H, W, 6), ``b`` (B, H, W, 3)."""

    module_names = ("a", "b")

    def has_module(self, name):
        return name in self.module_names

    def apply(self, params, x, tap_names=()):
        tap = JTap(tap_names)
        a = tap("a", jnp.concatenate([x, jax.nn.relu(x) * 2.0], axis=-1))
        b = tap("b", a[..., :3] * a[..., 3:])
        return jnp.mean(b, axis=(1, 2)), tap.taps


class _PortTaps(SubjectModel):
    module_names = ("a", "b")
    device = torch.device("cpu")

    def apply(self, params, x, tap_names=()):
        tap = TapCollector(tap_names)
        a = tap("a", torch.cat([x, torch.relu(x) * 2.0], dim=-1))
        b = tap("b", a[..., :3] * a[..., 3:])
        return b.mean(dim=(1, 2)), tap.taps


class _Identity(SubjectModel):
    """The image's channels are the tap: a planted dictionary streamed as (B, 4, 4, d) images."""

    module_names = ("x",)
    device = torch.device("cpu")

    def apply(self, params, x, tap_names=()):
        return x.mean(dim=(1, 2)), ({"x": x} if "x" in tap_names else {})


class _JaxIdentity:
    module_names = ("x",)

    def has_module(self, name):
        return name in self.module_names

    def apply(self, params, x, tap_names=()):
        return jnp.mean(x, axis=(1, 2)), ({"x": x} if "x" in tap_names else {})


IMAGES = np.random.default_rng(0).normal(size=(10, 5, 7, 3)).astype(np.float32)


def test_extractors_equal_jax_at_every_position():
    cfg = tsae.SAEConfig(d_in=6, n_latents=8, positions_per_image=0)
    jcfg = jsae.SAEConfig(d_in=6, n_latents=8, positions_per_image=0)
    gen = torch.Generator().manual_seed(0)
    rows = tsae._make_row_extractor(_PortTaps(), "a", cfg)({}, torch.from_numpy(IMAGES), gen)
    want = jsae._make_row_extractor(_JaxTaps(), "a", jcfg)({}, jnp.asarray(IMAGES), jax.random.PRNGKey(0))
    assert rows.dtype == torch.float32 and rows.shape == (10 * 35, 6)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want))
    xr, yr = tsae._make_pair_extractor(_PortTaps(), "a", "b", cfg)({}, torch.from_numpy(IMAGES), gen)
    jx, jy = jsae._make_pair_extractor(_JaxTaps(), "a", "b", jcfg)({}, jnp.asarray(IMAGES), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(xr.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(yr.numpy(), np.asarray(jy))


def test_sampled_positions_stay_paired_and_in_range():
    cfg = tsae.SAEConfig(d_in=6, n_latents=8, positions_per_image=4)
    gen = torch.Generator().manual_seed(0)
    rows = tsae._make_row_extractor(_PortTaps(), "a", cfg)({}, torch.from_numpy(IMAGES), gen)
    assert rows.shape == (10 * 4, 6)
    every = torch.from_numpy(np.concatenate([IMAGES, np.maximum(IMAGES, 0) * 2], -1)).reshape(10, 35, 6)
    for i in range(10):  # each sampled row is one of its own image's positions
        assert all((every[i] == r).all(-1).any() for r in rows[4 * i: 4 * i + 4])
    xr, yr = tsae._make_pair_extractor(_PortTaps(), "a", "b", cfg)({}, torch.from_numpy(IMAGES), gen)
    torch.testing.assert_close(yr, xr[:, :3] * xr[:, 3:], rtol=0, atol=0)  # the same positions index both taps


def test_streaming_trainer_on_a_planted_dictionary_against_jax():
    """Final fvu within 0.03 of the JAX trainer's. Measured on the CPU over seeds 1-5 (port, JAX):
    (0.319, 0.308), (0.338, 0.346), (0.342, 0.349), (0.352, 0.340), (0.339, 0.333) — |Δ| at most
    0.013, the JAX trainer's own range over the seeds 0.041 — so 0.03 is about twice the largest gap."""
    atoms, x = _planted_dictionary(n=4096)
    images = x.reshape(256, 4, 4, 16)
    kw = {"d_in": 16, "n_latents": 32, "k": 3, "lr": 2e-3, "batch_rows": 512, "positions_per_image": 8, "seed": 1}
    tp, tstats, tm = tsae.train_sae_on_layer(_Identity(), {}, TDS(images), "x", tsae.SAEConfig(**kw),
                                             batch_size=128, epochs=24)
    jp, jstats, jm = jsae.train_sae_on_layer(_JaxIdentity(), {}, JDS(images), "x", jsae.SAEConfig(**kw),
                                             batch_size=128, epochs=24)
    # 24 epochs × 2 full batches × (128 · 8 rows // 512) = 96 steps in both
    assert int(tstats["step"]) == int(jstats["step"]) == 96
    assert tm["l0"] == jm["l0"] == 3.0
    assert abs(tm["fvu"] - float(jm["fvu"])) <= 0.03, (tm["fvu"], float(jm["fvu"]))
    assert tp["k"] == 3 and tp["W_dec"].shape == (32, 16)


def test_streaming_transcoder_trainer():
    """The skip-free transcoder from tap ``a`` to ``b = 2·relu(x)²`` against the JAX trainer on the same
    aligned taps: final fvu within 0.015 of the JAX trainer's, and below 0.05. Measured on the CPU over
    seeds 0-4 (port, JAX): (0.0184, 0.0206), (0.0153, 0.0179), (0.0153, 0.0239), (0.0172, 0.0205),
    (0.0215, 0.0151) — |Δ| at most 0.0086, every fvu in 0.015-0.024 — so 0.015 is about twice the
    largest gap; a trainer that barely moves stays far above 0.05."""
    kw = dict(d_in=6, d_out=3, n_latents=64, k=8, lr=3e-3, batch_rows=128, positions_per_image=16, seed=0)
    images = np.random.default_rng(0).normal(size=(70, 12, 12, 3)).astype(np.float32)
    params, stats, metrics = tsae.train_transcoder_on_layer(_PortTaps(), {}, TDS(images), "a", "b",
                                                            tsae.SAEConfig(**kw), batch_size=32, epochs=48)
    _, jstats, jm = jsae.train_transcoder_on_layer(_JaxTaps(), {}, JDS(images), "a", "b", jsae.SAEConfig(**kw),
                                                   batch_size=32, epochs=48)
    assert np.isfinite(metrics["loss"]) and metrics["fvu"] < 0.05
    assert abs(metrics["fvu"] - float(jm["fvu"])) <= 0.015, (metrics["fvu"], float(jm["fvu"]))
    assert 0 < metrics["l0"] <= 8.0  # TopK keeps 8 slots; the ReLU zeroes those with negative pre-activations
    assert params["W_dec"].shape == (64, 3) and params["k"] == 8 and "b_in" in params
    # 48 epochs × 2 full batches × (32 · 16 // 128) = 384 steps in both
    assert int(stats["step"]) == int(jstats["step"]) == 384
