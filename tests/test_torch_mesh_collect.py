"""Data-parallel Collect over two gloo ranks against the JAX package's meshed and multi-host runs.

One spawned run (``parallel.launch.spawn``: two processes on the CPU, a
``FileStore`` in ``tmp_path``) drives the port's ``CollectEngine(mesh=…)``
(``run`` and ``run_fused`` over 22 rows at batch 4, the last batch padded;
a batch of 3 that two ranks cannot split), ``collect_multihost``,
``fused_multihost`` (with an empty shard on rank 1), ``gather_selected_rows``,
checkpoints in both directions with the JAX engine on ``data_mesh(2)``, and
the cached fused visualizer. In this process: the JAX engine on two of the
eight virtual CPU devices, the JAX multi-host functions in their
single-process simulation (the cases of JAX ``tests/test_multihost.py``),
and the port on one process.

Sample ids are equal everywhere. The port's top-k values equal its own
one-process values exactly; against the JAX package they are within one
bf16 step (2⁻⁷ relative: the float32 aggregates of the two packages may
differ in the last bits, ROADMAP queue 3).
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from semanticlens_tpu_torch.data import ArrayDataset, ImageFolder, host_shard_range
from semanticlens_tpu_torch.ops.topk import TopKState, topk_merge
from semanticlens_tpu_torch.parallel import gather_selected_rows, launch
from semanticlens_tpu_torch.parallel.multihost import fused_multihost, local_shard_sweep

import torch_mesh_ranks as ranks

torch.set_num_threads(2)

N_JPEGS = 10  # at batch 4 over two ranks: rank 1's rows of the last batch lie past the end


def _jax_engine(mesh=None):
    import jax.numpy as jnp

    from semanticlens_tpu.collect.engine import CollectEngine
    from semanticlens_tpu.models.base import SubjectModel, TapCollector
    from semanticlens_tpu.models.layers import conv2d
    from semanticlens_tpu.ops.aggregators import aggregate_conv_mean

    class JOneConv(SubjectModel):
        module_names = ("c",)

        def apply(self, params, x, tap_names=()):
            tap = TapCollector(tap_names)
            return tap("c", conv2d(x, params["w"])), tap.taps

    return CollectEngine(JOneConv(), ("c",), aggregate_conv_mean, 5, mesh=mesh), {"w": jnp.asarray(ranks.W_CONV)}


def _jembed(batch):
    import jax.numpy as jnp

    return jnp.mean(batch.astype(jnp.float32), axis=(1, 2)) @ jnp.asarray(ranks.PROJ)


def _np(state):
    return np.asarray(state.ids), np.asarray(state.values, np.float32)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Both ranks' results, and the JAX meshed checkpoint they resumed."""
    from semanticlens_tpu.core import data_mesh
    from semanticlens_tpu.data import ArrayDataset as JDataset

    out = tmp_path_factory.mktemp("mesh_collect")
    (out / "jpegs").mkdir()
    for i, image in enumerate(np.random.default_rng(11).integers(0, 256, (N_JPEGS, 12, 10, 3), dtype=np.uint8)):
        Image.fromarray(image).save(out / "jpegs" / f"{i:02d}.jpg", "JPEG", quality=90)
    engine, params = _jax_engine(data_mesh(2))
    engine.run(params, JDataset(ranks.IMAGES[: ranks.CKPT_ROWS]), 8, checkpoint_dir=out / "jax_ckpt",
               checkpoint_every=1)
    launch.spawn(ranks.collect_ranks, 2, out / "work", args=(str(out), str(out / "jax_ckpt")), timeout_s=120)
    results = [dict(np.load(out / f"collect{r}.npz")) for r in range(2)]
    metas = [json.loads((out / f"collect{r}.json").read_text()) for r in range(2)]
    return out, results, metas


def test_every_rank_returns_the_same_result(world2):
    _, (a, b), _ = world2
    assert sorted(a) == sorted(b)
    for key in a:
        if key not in ("rows", "core/shard_batch"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_core_helpers_split_broadcast_and_check(world2):
    from semanticlens_tpu_torch.core import backend_reachable, enable_compilation_cache, init_distributed
    from semanticlens_tpu_torch.utils.cuda_build import BUILD_DIR

    _, (a, b), metas = world2
    np.testing.assert_array_equal(a["core/shard_batch"], np.arange(4))
    np.testing.assert_array_equal(b["core/shard_batch"], np.arange(4, 8))
    np.testing.assert_array_equal(b["core/replicated"], np.zeros(3))  # rank 0's values on every rank
    assert "has 2 ranks" in metas[1]["mesh_size"]
    assert enable_compilation_cache() == str(BUILD_DIR)
    assert backend_reachable(1, timeout_s=60) is False  # no card in this process's reach
    with pytest.raises(ValueError, match="nccl.*gloo"):
        init_distributed("mpi")


@pytest.mark.parametrize("kind", ["run", "fused"])
def test_meshed_engine_matches_jax_mesh_and_one_process(world2, kind):
    from semanticlens_tpu.core import data_mesh
    from semanticlens_tpu.data import ArrayDataset as JDataset

    _, (got, _), metas = world2
    ds = ArrayDataset(ranks.IMAGES[: ranks.N_SWEEP])
    engine, params = _jax_engine(data_mesh(2))
    jds = JDataset(ranks.IMAGES[: ranks.N_SWEEP])
    if kind == "run":
        jstates, _ = engine.run(params, jds, ranks.BATCH)
        plain, _ = ranks.conv_engine().run(ranks.CONV_PARAMS, ds, ranks.BATCH)
    else:
        jstates, jembeds, _ = engine.run_fused(params, jds, ranks.BATCH, _jembed)
        plain, embeds, _ = ranks.conv_engine().run_fused(ranks.CONV_PARAMS, ds, ranks.BATCH, ranks.embed)
        np.testing.assert_array_equal(got["fused/embeds"], embeds)
        np.testing.assert_allclose(got["fused/embeds"], jembeds, rtol=1e-5, atol=1e-6)
    ids, values = _np(jstates["c"])
    np.testing.assert_array_equal(got[f"{kind}/c/ids"], ids)
    np.testing.assert_allclose(got[f"{kind}/c/values"], values, rtol=2**-7)
    np.testing.assert_array_equal(got[f"{kind}/c/ids"], plain["c"].ids.numpy())
    np.testing.assert_array_equal(got[f"{kind}/c/values"], plain["c"].values.float().numpy())
    assert "divisible by data-parallel degree 2" in metas[0]["odd_batch"]


def test_meshed_engine_decodes_only_its_rows_of_an_image_folder(world2):
    out, results, metas = world2
    folder = ImageFolder(out / "jpegs", image_size=8, device="cpu")
    plain, _ = ranks.conv_engine().run(ranks.CONV_PARAMS, folder, ranks.BATCH)
    for got in results:
        np.testing.assert_array_equal(got["folder/c/ids"], plain["c"].ids.numpy())
        np.testing.assert_array_equal(got["folder/c/values"], plain["c"].values.float().numpy())
    per = ranks.BATCH // 2
    for rank, meta in enumerate(metas):
        own = [f"{i:02d}.jpg" for i in range(N_JPEGS) if (i % ranks.BATCH) // per == rank]
        # each image once: the states are sized from the first batch, with no forward of their own
        assert meta["folder_decoded"] == sorted(own)


def test_multihost_functions_match_jax_simulation_and_one_process(world2):
    from semanticlens_tpu.data import ArrayDataset as JDataset
    from semanticlens_tpu.parallel import fused_multihost as j_fused
    from semanticlens_tpu.parallel.multihost import gather_selected_rows as j_gather

    _, (got, _), _ = world2
    ds = ArrayDataset(ranks.IMAGES[: ranks.N_SWEEP])
    plain, _ = ranks.conv_engine().run(ranks.CONV_PARAMS, ds, ranks.BATCH)
    np.testing.assert_array_equal(got["multihost/c/ids"], plain["c"].ids.numpy())
    np.testing.assert_array_equal(got["multihost/c/values"], plain["c"].values.float().numpy())
    # one process: the JAX function's fused sweep + gather
    engine, params = _jax_engine()
    jstates, jdb, _ = j_fused(engine, params, JDataset(ranks.IMAGES[: ranks.N_SWEEP]), ranks.BATCH,
                              _jembed)
    np.testing.assert_array_equal(got["fusedmh/c/ids"], np.asarray(jstates["c"].ids))
    np.testing.assert_allclose(got["fusedmh/db"], np.asarray(jdb["c"]), rtol=1e-5, atol=1e-6)
    _, tdb, _ = fused_multihost(ranks.conv_engine(), ranks.CONV_PARAMS, ds, ranks.BATCH, ranks.embed)
    np.testing.assert_array_equal(got["fusedmh/db"], tdb["c"])
    # the all-gather-then-sum: rows 1 and 4, 6, 7 owned by ranks 0 and 1
    local = [np.arange(12, dtype=np.float32).reshape(4, 3) + 100 * r for r in range(2)]
    want = sum(j_gather(np.array([1, 4, 6, 7]), local[r], 4 * r, 4 * r + 4) for r in range(2))
    np.testing.assert_array_equal(got["rows"], want)


def test_empty_shard_gives_full_shape_states_and_rows(world2):
    _, (got, _), _ = world2
    one = ArrayDataset(ranks.IMAGES[:1])
    plain, _ = ranks.conv_engine().run(ranks.CONV_PARAMS, one, ranks.BATCH)
    _, db, _ = fused_multihost(ranks.conv_engine(), ranks.CONV_PARAMS, one, ranks.BATCH, ranks.embed)
    for kind in ("empty", "emptyfused"):
        assert got[f"{kind}/c/ids"].shape == (6, 5)
        np.testing.assert_array_equal(got[f"{kind}/c/ids"], plain["c"].ids.numpy())
    np.testing.assert_array_equal(got["emptyfused/db"], db["c"])


def test_single_process_simulation_matches_jax_multihost_cases():
    """JAX ``test_simulated_multihost_equals_single_host`` and the shard arithmetic, in the port."""
    from semanticlens_tpu.data.grain_adapter import host_shard_range as j_range

    for n, pc in [(22, 3), (8, 8), (5, 8), (0, 2), (24, 2)]:
        ranges = [host_shard_range(n, process_index=i, process_count=pc) for i in range(pc)]
        assert ranges == [j_range(n, process_index=i, process_count=pc) for i in range(pc)]
    assert host_shard_range(10) == (0, 10)  # no process group: one process owns everything
    ds = ArrayDataset(ranks.IMAGES[: ranks.N_SWEEP])
    ref, _ = ranks.conv_engine().run(ranks.CONV_PARAMS, ds, ranks.BATCH)
    parts = []
    for pi in range(3):
        start, stop = host_shard_range(len(ds), process_index=pi, process_count=3)
        states, seen = local_shard_sweep(ranks.conv_engine(), ranks.CONV_PARAMS, ds, ranks.BATCH, start, stop)
        assert seen == stop - start
        parts.append(states["c"])
    merged = topk_merge(TopKState(values=torch.stack([s.values for s in parts]),
                                  ids=torch.stack([s.ids for s in parts])))
    assert torch.equal(merged.ids, ref["c"].ids) and torch.equal(merged.values, ref["c"].values)
    table = gather_selected_rows(np.array([2, 5]), np.ones((3, 4), np.float32), 1, 4)
    np.testing.assert_array_equal(table, [[1] * 4, [0] * 4])


def test_int32_id_guard_holds_for_shards():
    with pytest.raises(ValueError, match="int32"):
        ranks.conv_engine().run(ranks.CONV_PARAMS, ArrayDataset(ranks.IMAGES[:4]), 4, id_offset=2**31 - 2)


def test_checkpoints_cross_between_packages_at_world_2(world2):
    from semanticlens_tpu.core import data_mesh
    from semanticlens_tpu.data import ArrayDataset as JDataset

    out, (got, _), _ = world2
    engine, params = _jax_engine(data_mesh(2))
    jref, _ = engine.run(params, JDataset(ranks.IMAGES), 8)
    ids, values = _np(jref["c"])
    # the JAX package's meshed checkpoint (2, C, k) resumed by the port's two ranks
    np.testing.assert_array_equal(got["resumed/c/ids"], ids)
    np.testing.assert_allclose(got["resumed/c/values"], values, rtol=2**-7)
    # the port's meshed checkpoint resumed by the JAX engine on data_mesh(2)
    progress = json.loads((out / "port_ckpt" / "progress.json").read_text())
    assert progress == {"next_start": ranks.CKPT_ROWS, "layers": ["c"]}
    from semanticlens_tpu_torch.utils import safetensors_io

    assert tuple(safetensors_io.load_file(out / "port_ckpt" / "state-c.safetensors")["ids"].shape) == (2, 6, 5)
    jstates, _ = engine.run(params, JDataset(ranks.IMAGES), 8, checkpoint_dir=out / "port_ckpt", checkpoint_every=1)
    np.testing.assert_array_equal(np.asarray(jstates["c"].ids), ids)
    np.testing.assert_allclose(np.asarray(jstates["c"].values, np.float32), values, rtol=2**-7)
    # an unmeshed engine refuses the (2, C, k) states
    with pytest.raises(ValueError, match="data shard"):
        ranks.conv_engine().load_checkpoint(out / "port_ckpt")


def test_meshed_visualizer_writes_one_cache_equal_to_one_process(world2, tmp_path):
    from semanticlens_tpu_torch import Lens
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean

    out, (got, _), _ = world2
    ds = ArrayDataset(ranks.IMAGES[: ranks.N_SWEEP], name="imgs")
    cv = ActivationComponentVisualizer(ranks.OneConv(), ds, ds, ["c"], 5, aggregate_fn=aggregate_conv_mean,
                                       cache_dir=tmp_path, params=ranks.CONV_PARAMS)
    db = Lens(ranks.FakeVLM()).compute_concept_db(cv, batch_size=ranks.BATCH, checkpoint=8)
    np.testing.assert_array_equal(got["cv/db"], db["c"])
    np.testing.assert_array_equal(got["cv/table"], cv.embedding_table)
    written = sorted(p.relative_to(out / "cache").as_posix() for p in (out / "cache").rglob("*") if p.is_file())
    want = sorted(p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*") if p.is_file())
    assert written == want and not any("_checkpoint" in w for w in written)
