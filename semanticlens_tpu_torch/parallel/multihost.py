"""Multi-process Collect: per-process dataset shards + one global top-k merge.

Counterpart of ``semanticlens_tpu.parallel.multihost`` on
``torch.distributed``. Each process (one per card) sweeps only its own
contiguous shard of the dataset (:func:`~semanticlens_tpu_torch.data.dataset.host_shard_range`,
sample ids kept *global* through ``id_offset``) with an ordinary
single-device :class:`~semanticlens_tpu_torch.collect.engine.CollectEngine`,
and the cross-process exchanges are small: the per-layer (C, k) top-k
states, and for the fused sweep only the embedding rows the merged top-k
selected.

Usage, in every process of a group (``core.init_distributed``)::

    engine = CollectEngine(model, layers, agg_fn, k)        # this rank's card
    states, n = collect_multihost(engine, params, dataset, batch_size)
    # every process returns the same globally merged states

Exchanges run on the backend's device (``core.mesh.comm_device``): the
card for NCCL, the CPU for gloo. Without a process group (or with one
process) every function is the single-process computation.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.distributed as dist

from semanticlens_tpu_torch.core.mesh import all_gather
from semanticlens_tpu_torch.data.dataset import Subset, get_image, host_shard_range
from semanticlens_tpu_torch.ops.topk import TopKState, topk_merge

logger = logging.getLogger(__name__)

__all__ = ["collect_multihost", "fused_multihost", "gather_selected_rows", "local_shard_sweep",
           "merge_states_across_processes"]


def _world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def merge_states_across_processes(states: dict[str, TopKState]) -> dict[str, TopKState]:
    """All-gather per-process top-k states and select the global top-k.

    Each process contributes its (C, k) state per layer; the gathered
    (P, C, k) stack goes through the deterministic
    :func:`~semanticlens_tpu_torch.ops.topk.topk_merge` that merges a data
    mesh's shards, so multi-process, meshed and single-card sweeps give the
    same ids (sentinel tie-break included). No-op on a single process.
    """
    if _world()[1] == 1:
        return states
    return {name: topk_merge(TopKState(values=all_gather(st.values, None), ids=all_gather(st.ids, None)))
            for name, st in states.items()}


def local_shard_sweep(engine, params, dataset, batch_size: int, start: int, stop: int, **run_kwargs):
    """One process's sweep over dataset rows [start, stop) with global ids.

    An empty shard (small dataset, many processes) still returns states of
    the full (C, k) shape — every process must contribute identically
    shaped tensors to the all-gather, and ``engine.run``'s empty-dataset
    early return is a (1, k) placeholder.
    """
    if stop == start:
        return engine.sentinel_states(params, dataset), 0
    states, seen = engine.run(params, Subset(dataset, start, stop), batch_size, id_offset=start, **run_kwargs)
    if seen != stop - start:
        raise RuntimeError(f"process swept {seen} samples, its shard holds {stop - start}")
    return states, seen


def collect_multihost(engine, params, dataset, batch_size: int, **run_kwargs):
    """Full multi-process Collect sweep; returns (merged states, global n).

    The local sweep takes every ``CollectEngine.run`` keyword (checkpoints
    included: each process checkpoints its own shard's progress).
    """
    n = len(dataset)
    start, stop = host_shard_range(n)
    rank, world = _world()
    logger.info("process %d/%d collecting shard [%d, %d) of %d", rank, world, start, stop, n)
    states, _ = local_shard_sweep(engine, params, dataset, batch_size, start, stop, **run_kwargs)
    return merge_states_across_processes(states), n


def _selected_global_ids(states: dict[str, TopKState]) -> np.ndarray:
    """Sorted unique non-sentinel sample ids across all layers' merged top-k."""
    all_ids = np.concatenate([st.ids.cpu().numpy().ravel() for st in states.values()])
    return np.unique(all_ids[all_ids >= 0])


def gather_selected_rows(needed_ids: np.ndarray, local_rows: np.ndarray, shard_start: int, shard_stop: int
                         ) -> np.ndarray:
    """(M, D) float32 embedding rows for ``needed_ids``, exchanged across processes.

    Each process owns the rows of its shard [shard_start, shard_stop); it
    fills its slice of an (M, D) buffer and the exchange is an
    all-gather-then-sum (every id has exactly one owner, so the sum
    rebuilds the table). Wire cost is O(M·D): the selected rows only, never
    the full (N, D) table.
    """
    m = int(needed_ids.shape[0])
    d = int(local_rows.shape[-1])
    table = np.zeros((m, d), np.float32)
    in_shard = (needed_ids >= shard_start) & (needed_ids < shard_stop)
    table[np.where(in_shard)[0]] = np.asarray(local_rows, np.float32)[needed_ids[in_shard] - shard_start]
    if _world()[1] == 1:
        return table
    return all_gather(torch.from_numpy(table), None).sum(dim=0).numpy()


def fused_multihost(engine, params, dataset, batch_size: int, embed_fn, **run_kwargs):
    """Multi-process fused Collect + Embed; returns (states, concept_db, n).

    Each process runs ``engine.run_fused`` over its own contiguous shard
    (global ids through ``id_offset``, embedding rows kept shard-local),
    then two small exchanges follow: the per-layer (C, k) states merge
    (:func:`merge_states_across_processes`), and only the embedding rows
    the merged top-k selected move (:func:`gather_selected_rows`).

    ``concept_db[layer]`` is (C, k, D) float32 with zero rows at −1
    sentinels, identical to a single-process fused sweep plus gather.
    Every process returns the same result. A process with an empty shard
    learns the embedding width from one real image of the dataset.
    """
    n = len(dataset)
    start, stop = host_shard_range(n)
    rank, world = _world()
    logger.info("process %d/%d fused sweep over shard [%d, %d) of %d", rank, world, start, stop, n)
    if stop == start:
        states = engine.sentinel_states(params, dataset)
        with torch.inference_mode():
            probe = torch.from_numpy(np.ascontiguousarray(get_image(dataset, 0)[None])).to(engine.device)
            width = int(embed_fn(probe).shape[-1])
        local_embeds = np.zeros((0, width), np.float32)
    else:
        states, local_embeds, seen = engine.run_fused(params, Subset(dataset, start, stop), batch_size, embed_fn,
                                                      id_offset=start, **run_kwargs)
        if seen != stop - start:
            raise RuntimeError(f"process swept {seen} samples, its shard holds {stop - start}")

    merged = merge_states_across_processes(states)
    needed = _selected_global_ids(merged)
    rows = gather_selected_rows(needed, local_embeds, start, stop)

    concept_db = {}
    for name, st in merged.items():
        ids = st.ids.cpu().numpy().astype(np.int64)
        c, k = ids.shape
        db = np.zeros((c * k, rows.shape[1]), np.float32)
        flat = ids.ravel()
        valid = flat >= 0
        db[valid] = rows[np.searchsorted(needed, flat[valid])]  # needed is sorted
        concept_db[name] = db.reshape(c, k, -1)
    return merged, concept_db, n
