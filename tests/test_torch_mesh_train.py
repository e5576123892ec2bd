"""Data-parallel SAE training, feature synthesis and sharded Analyze over two gloo ranks.

One spawned run on a 2-rank ``data_mesh``, against the port on one process
and the JAX package on ``data_mesh(2)`` of its virtual CPU devices:

- ``train_sae_from_rows`` (TopK + AuxK with dead latents) and the
  transcoder trainer, 10 steps from the JAX package's initial parameters.
  Each rank computes its columns' part of the global minibatch's loss, the
  gradients are summed before ``ClipAdam``, so the dictionary equals the
  one-process dictionary up to float32 summation order. The bound is
  measured: over these cases the parameters read ≤ 2.5e-7 of their scale
  from the one-process trainer and ≤ 3.2e-7 from the JAX mesh run
  (``SAE_REL`` 1e-5, the one-process trainer's bound against JAX);
  ``last_fired`` is equal, and the metrics agree to 1e-5;
- the streaming trainers (``train_sae_on_layer`` on a planted dictionary,
  ``train_transcoder_on_layer``; the cases of ``test_torch_sae_train.py``)
  step through one process's minibatches: positions and permutations are
  drawn for the whole batch from one stream and each rank takes its
  columns. Their dictionaries equal the one-process run's within
  ``STREAM_REL`` (measured below), and their final fvu is held to the JAX
  trainers' on ``data_mesh(2)`` within the bounds that file measured for
  one process (the streams are ``torch.Generator`` and ``jax.random``);
- ``featviz.synthesize`` with K = 4 canvases split 2 + 2 equals the
  one-device synthesis (images and objectives within 1e-6, the draws taken
  by canvas index from one stream);
- clarity, polysemanticity and redundancy on ``core.shard_concept_db``
  (JAX ``tests/test_sharded_scores.py``: 16 components split, 17 kept
  whole) equal the unsharded scores; clarity and redundancy match the JAX
  package's sharded scores (1e-5), polysemanticity the port's unsharded
  run (its k-means draws are indexed by component, so a rank's components
  draw what one process draws for them);
- ``RelevanceComponentVisualizer`` splits the components of its concept DB
  over the ranks (attribution and embedding) and equals one process.
"""

import json

import numpy as np
import pytest
import torch

from semanticlens_tpu_torch import featviz, sae
from semanticlens_tpu_torch.parallel import launch
from semanticlens_tpu_torch.scores import clarity_score, polysemanticity_score, redundancy_score

import torch_mesh_ranks as ranks

torch.set_num_threads(2)

STEPS = 10
SAE_KW = {"d_in": 10, "n_latents": 256, "lr": 3e-3, "batch_rows": 64, "seed": 3, "k": 2, "aux_k": 12,
          "dead_steps": 2}
TC_KW = {"d_in": 10, "n_latents": 48, "lr": 3e-3, "batch_rows": 64, "seed": 3, "k": 4, "d_out": 6, "skip": True}
SAE_REL = 1e-5
STREAM_REL = 1e-5


def _inputs():
    import jax

    from semanticlens_tpu import sae as jsae

    rng = np.random.default_rng(1)
    rows = rng.normal(size=(200, 10)).astype(np.float32)
    targets = np.tanh(rows @ rng.normal(size=(10, 6))).astype(np.float32)
    inputs = {"rows": rows, "targets": targets, "steps": np.int64(STEPS), "sae_cfg": json.dumps(SAE_KW),
              "tc_cfg": json.dumps(TC_KW)}
    for tag, kw in (("sae", SAE_KW), ("tc", TC_KW)):
        cfg = jsae.SAEConfig(**kw)
        init = {n: np.asarray(v) for n, v in jsae.init_sae(jax.random.PRNGKey(5), cfg).items()}
        if cfg.is_transcoder:
            init = {n: np.asarray(v) for n, v in jsae._calibrate_transcoder_init(init, rows, targets).items()}
        inputs |= {f"{tag}_init/{n}": v for n, v in init.items()}
    planted = np.random.default_rng(0)
    atoms = planted.normal(size=(24, 16))
    atoms /= np.linalg.norm(atoms, axis=1, keepdims=True)
    codes = np.zeros((4096, 24), np.float32)
    for i in range(4096):
        codes[i, planted.choice(24, 3, replace=False)] = planted.uniform(0.5, 2.0, 3)
    x = codes @ atoms + 0.01 * planted.normal(size=(4096, 16))
    inputs["planted"] = x.astype(np.float32).reshape(256, 4, 4, 16)
    inputs["tc_images"] = np.random.default_rng(0).normal(size=(70, 12, 12, 3)).astype(np.float32)
    db_rng = np.random.default_rng(0)
    inputs["db"] = db_rng.normal(size=(16, 6, 32)).astype(np.float32)
    inputs["db_odd"] = db_rng.normal(size=(17, 6, 32)).astype(np.float32)  # 17 does not divide 2: kept whole
    return inputs


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_train")
    inputs = _inputs()
    np.savez(out / "inputs.npz", **inputs)
    launch.spawn(ranks.train_ranks, 2, out / "work", args=(str(out), str(out / "inputs.npz")), timeout_s=150)
    return ([dict(np.load(out / f"train{r}.npz")) for r in range(2)],
            [json.loads((out / f"train{r}.json").read_text()) for r in range(2)], inputs)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def test_every_rank_ends_with_the_same_dictionaries_and_scores(world2):
    (a, b), (ma, mb), _ = world2
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert ma == mb
    assert all(np.isfinite(v) for v in ma["stream_metrics"].values())


def _jax_stream_models():
    import jax.numpy as jnp

    from semanticlens_tpu.models.base import TapCollector

    class JIdentity:
        module_names = ("x",)

        def has_module(self, name):
            return name in self.module_names

        def apply(self, params, x, tap_names=()):
            return jnp.mean(x, axis=(1, 2)), ({"x": x} if "x" in tap_names else {})

    class JPairTaps:
        module_names = ("a", "b")

        def has_module(self, name):
            return name in self.module_names

        def apply(self, params, x, tap_names=()):
            tap = TapCollector(tap_names)
            a = tap("a", jnp.concatenate([x, jnp.maximum(x, 0) * 2.0], axis=-1))
            b = tap("b", a[..., :3] * a[..., 3:])
            return jnp.mean(b, axis=(1, 2)), tap.taps

    return {"stream": JIdentity(), "stream_tc": JPairTaps()}


@pytest.mark.parametrize("tag", ["stream", "stream_tc"])
def test_streaming_dp_trainer_equals_one_process_and_jax_mesh(world2, tag):
    """World 2 against one process: the same minibatches, float32 sums in another order (``STREAM_REL``).
    Against the JAX trainer on ``data_mesh(2)``: the final fvu within ``test_torch_sae_train.py``'s
    one-process bounds (0.03 for the SAE, 0.015 for the transcoder), since the streams differ."""
    from semanticlens_tpu import sae as jsae
    from semanticlens_tpu.core import data_mesh
    from semanticlens_tpu.data import ArrayDataset as JDataset

    from semanticlens_tpu_torch.data import ArrayDataset

    (got, _), (meta, _), inputs = world2
    model, taps, images, kw = ranks.stream_cases(inputs)[tag]
    trainer = sae.train_sae_on_layer if len(taps) == 1 else sae.train_transcoder_on_layer
    one, stats, metrics = trainer(model, {}, ArrayDataset(images), *taps, sae.SAEConfig(**kw), **ranks.STREAM_RUNS[tag])
    assert meta[f"{tag}_steps"] == int(stats["step"])
    for name, value in one.items():
        if name != "k":
            assert _rel(got[f"{tag}/{name}"], value.numpy()) <= STREAM_REL, name
    for name in ("loss", "fvu", "l0", "mse"):
        assert meta[f"{tag}_metrics"][name] == pytest.approx(metrics[name], rel=STREAM_REL, abs=1e-7), name
    jtrainer = jsae.train_sae_on_layer if len(taps) == 1 else jsae.train_transcoder_on_layer
    _, jstats, jm = jtrainer(_jax_stream_models()[tag], {}, JDataset(images), *taps, jsae.SAEConfig(**kw),
                             mesh=data_mesh(2), **ranks.STREAM_RUNS[tag])
    assert int(jstats["step"]) == meta[f"{tag}_steps"]
    assert abs(meta[f"{tag}_metrics"]["fvu"] - float(jm["fvu"])) <= {"stream": 0.03, "stream_tc": 0.015}[tag]


@pytest.mark.parametrize("tag", ["sae", "tc"])
def test_dp_trainer_equals_one_process_and_jax_mesh(world2, tag):
    from semanticlens_tpu import sae as jsae
    from semanticlens_tpu.core import data_mesh

    (got, _), (meta, _), inputs = world2
    kw = SAE_KW if tag == "sae" else TC_KW
    init = {k.split("/", 1)[1]: v for k, v in inputs.items() if k.startswith(f"{tag}_init/")}
    targets = inputs["targets"] if tag == "tc" else None
    one, stats, metrics = sae.train_sae_from_rows(inputs["rows"], sae.SAEConfig(**kw), targets=targets, steps=STEPS,
                                                  params=init, device="cpu")
    jp, jstats, jm = jsae.train_sae_from_rows(inputs["rows"], jsae.SAEConfig(**kw), targets=targets, steps=STEPS,
                                              params=init, mesh=data_mesh(2))
    for name, value in one.items():
        if name == "k":
            continue
        assert _rel(got[f"{tag}/{name}"], value.numpy()) <= SAE_REL, name
        assert _rel(got[f"{tag}/{name}"], np.asarray(jp[name])) <= SAE_REL, name
    np.testing.assert_array_equal(got[f"{tag}/last_fired"], stats["last_fired"].numpy())
    np.testing.assert_array_equal(got[f"{tag}/last_fired"], np.asarray(jstats["last_fired"]))
    for name in ("loss", "fvu", "l0", "mse"):
        assert meta[f"{tag}_metrics"][name] == pytest.approx(metrics[name], rel=SAE_REL, abs=1e-7), name
        assert meta[f"{tag}_metrics"][name] == pytest.approx(float(jm[name]), rel=SAE_REL, abs=1e-7), name
    if tag == "sae":
        assert (stats["last_fired"] >= 2).any()  # AuxK had dead latents: its terms were reduced


def test_synthesis_over_two_ranks_equals_one_device(world2):
    (got, _), _, _ = world2
    cfg = featviz.SynthesisConfig(steps=4, lr=0.05, jitter=1)
    images, objective, trace = featviz.synthesize(ranks.OneConv(), ranks.CONV_PARAMS, "c", [0, 3, 5, 1],
                                                  lambda t: t.mean(dim=(1, 2)), image_size=6, config=cfg, seed=3,
                                                  return_trace=True)
    np.testing.assert_allclose(got["syn/images"], images, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["syn/objective"], objective, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["syn/trace"], trace, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="1-D"):
        featviz.synthesize(ranks.OneConv(), ranks.CONV_PARAMS, "c", [[0]], lambda t: t.mean(dim=(1, 2)))


def test_sharded_scores_equal_unsharded_and_jax(world2):
    import jax
    import jax.numpy as jnp

    from semanticlens_tpu import scores as jscores
    from semanticlens_tpu.core import data_mesh, shard_concept_db

    (got, _), (meta, _), inputs = world2
    assert meta["sharded"] == {"layer4": "ShardedRows", "odd": "Tensor"}
    raw = {"layer4": inputs["db"], "odd": inputs["db_odd"]}
    jsharded = shard_concept_db(raw, data_mesh(2))
    for name, v in raw.items():
        v = torch.from_numpy(v)
        np.testing.assert_allclose(got[f"clarity/{name}"], clarity_score(v).numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got[f"poly/{name}"], polysemanticity_score(v).numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[f"clarity/{name}"], np.asarray(jscores.clarity_score(jsharded[name])),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["lens/clarity"], got["clarity/layer4"])
    np.testing.assert_array_equal(got["lens/poly"], got["poly/layer4"])
    agg = inputs["db"].mean(1)
    np.testing.assert_allclose(got["redundancy"], redundancy_score(torch.from_numpy(agg)).numpy(), rtol=1e-6)
    jagg = jax.device_put(jnp.asarray(agg), jax.sharding.NamedSharding(data_mesh(2), jax.sharding.PartitionSpec("data")))
    np.testing.assert_allclose(got["redundancy"], np.asarray(jscores.redundancy_score(jagg)), rtol=1e-5, atol=1e-6)


def test_kmeans_draws_are_indexed_by_component():
    """A slice of the layer clustered with ``rows=(start, total)`` gets the whole layer's draws for it."""
    from semanticlens_tpu_torch.ops.kmeans import batched_kmeans

    v = torch.from_numpy(np.random.default_rng(2).normal(size=(10, 6, 4)).astype(np.float32))
    whole = batched_kmeans(v, 2, seed=7)
    part = batched_kmeans(v[4:7], 2, seed=7, rows=(4, 10))
    for w, p in zip(whole, part):
        torch.testing.assert_close(p, w[4:7], rtol=1e-6, atol=1e-6)


def test_relevance_concept_db_split_by_component_equals_one_process(world2, tmp_path):
    (got, _), _, _ = world2
    np.testing.assert_array_equal(got["relevance/db"], ranks.relevance_db(tmp_path))
