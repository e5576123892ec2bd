"""Streaming Collect engine: forward → aggregate → top-k, batch by batch on the card.

Counterpart of ``semanticlens_tpu.collect.engine``. Per batch: the uint8
images upload once (pinned memory, side stream), are normalized on the
device by ``input_preprocess``, run through the tapped
subject model, each tap is aggregated to (B, C), padded rows are set to −inf
and the batch is merged into the per-layer :class:`TopKState`. Sample ids
derive from the batch start and the dataset length, as in the JAX package.

``run`` (Collect), ``run_fused`` (Collect + Embed on one upload per image)
and ``run_embed`` (Embed alone) are one batch loop, ``_sweep``; the states
are sized from its first batch, so a sweep runs one forward a batch.

With ``checkpoint_dir`` and ``checkpoint_every`` (batches) a sweep persists
its running top-k states and its embedding rows, and resumes from the last
commit after a crash with the same result as an uninterrupted sweep. The
files are the JAX package's, key for key, so a sweep checkpointed by either
package resumes in the other: ``state-{layer}.safetensors`` (``values``
bf16, ``ids`` int32), ``embeds-{first row:012d}.safetensors`` (``embeds``
f32) and ``progress.json`` (``next_start``, and ``layers`` where the sweep
collects).

With ``mesh=`` (a ``DeviceMesh`` from :mod:`semanticlens_tpu_torch.core`,
one process per card) the sweep is data-parallel as the JAX engine's
``shard_map`` path is: rank ``r`` of ``W`` on the ``"data"`` axis takes
rows ``[r·B/W, (r+1)·B/W)`` of every global batch of ``B`` (the sample ids
the JAX engine gives shard ``r``), keeps its own (C, k) state, and the
final states are all-gathered to (W, C, k) and merged by
``ops.topk.topk_merge``: every rank returns the same states, whose ids are
the JAX meshed run's. A sweep that embeds all-gathers each batch's rows in
global order, so every rank holds the (N, D) table. Checkpoints under a
data mesh keep the JAX meshed layout: ``state-{layer}`` holds (W, C, k)
values and ids, written by global rank 0 after a gather, followed by a
barrier, so a sweep checkpointed by either package at ``W`` shards resumes
in the other at world ``W``. A mesh with a ``"model"`` axis
(``core.data_model_mesh``) selects the tensor-parallel mode: the caller's
parameters are DTensors (``parallel.shard_params``), the forward runs
unchanged under ``implicit_replication``, and the taps are gathered whole
before aggregation, so the top-k state is the same on every rank of a
model group.

The JAX engine memoizes its jitted step and keys the memo on
``interventions_fingerprint`` (a step traced inside an ``interventions``
context bakes the rewrites in). This engine runs each batch eagerly and
memoizes no captured program, so every forward consults the interventions
active at that moment and needs no such key.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from semanticlens_tpu_torch.core.mesh import (
    all_gather,
    barrier,
    full_tensor,
    is_tensor_parallel,
    is_writer,
    mesh_axis,
    tensor_parallel_region,
)
from semanticlens_tpu_torch.data.dataset import device_prefetch_batches, get_image, iter_batches, prefetch_batches
from semanticlens_tpu_torch.models.base import SubjectModel
from semanticlens_tpu_torch.ops.topk import TopKState, init_topk, topk_merge, topk_update
from semanticlens_tpu_torch.utils import safetensors_io
from semanticlens_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

# Embeddings of the fused pass stay on the device up to this many bytes and
# then drain to host memory, so a long sweep holds at most this plus one batch.
EMBED_FLUSH_BYTES = 512 * 2**20


class EmbedSink:
    """The embedding rows of a sweep, in order, from the device to host memory and disk.

    Rows stay on the device until ``EMBED_FLUSH_BYTES`` of them are pending,
    then drain to host memory in one copy. :meth:`commit` drains and returns
    the rows since the last commit, the next checkpoint chunk, and starts
    the next; :meth:`table` returns every row, each exactly once.
    """

    def __init__(self, host_chunks: list[np.ndarray] | None = None, flushed_rows: int = 0):
        self.host_chunks = host_chunks or []  # committed (or resumed) rows
        self.flushed_rows = flushed_rows  # first row not yet committed
        self.since_commit: list[np.ndarray] = []
        self.pending: list[torch.Tensor] = []
        self.pending_bytes = 0

    def add(self, emb: torch.Tensor):
        self.pending.append(emb)
        self.pending_bytes += emb.numel() * emb.element_size()
        if self.pending_bytes >= EMBED_FLUSH_BYTES:
            self.drain()

    def drain(self):
        if self.pending:
            with span("collect.drain", self.pending[0].device):
                self.since_commit.append(torch.cat(self.pending).to("cpu", torch.float32).numpy())
            self.pending, self.pending_bytes = [], 0

    def commit(self, next_start: int) -> tuple[int, np.ndarray]:
        """``(first row, rows)`` since the last commit; ``next_start`` is the row after them."""
        self.drain()
        first, chunk = self.flushed_rows, np.concatenate(self.since_commit, axis=0)
        self.host_chunks.append(chunk)
        self.since_commit = []
        self.flushed_rows = next_start
        return first, chunk

    def table(self, n: int) -> np.ndarray:
        self.drain()
        return np.concatenate(self.host_chunks + self.since_commit, axis=0)[:n]


class CollectEngine:
    """Streaming top-k collector over a dataset for a set of tapped layers.

    Parameters
    ----------
    model : SubjectModel with functional ``apply``; runs on ``model.device``.
    layer_names : taps to collect.
    aggregation_fn : reduces raw taps to (B, n_components).
    n_collect : top-k per component.
    mesh : optional ``DeviceMesh`` with a ``"data"`` axis (data parallelism;
        the batch size must be divisible by the axis size) and optionally a
        ``"model"`` axis (tensor parallelism over DTensor parameters).
    input_preprocess : optional device-side fn applied to each raw batch
        before the model (e.g. uint8 → normalized float). Defaults to a
        float32 cast.
    """

    def __init__(
        self,
        model: SubjectModel,
        layer_names: Sequence[str],
        aggregation_fn: Callable,
        n_collect: int,
        mesh=None,
        input_preprocess: Callable | None = None,
    ):
        self.model = model
        self.device = model.device
        self.layer_names = tuple(layer_names)
        self.aggregation_fn = aggregation_fn
        self.n_collect = n_collect
        self.n_shards, self.shard, self.group = mesh_axis(mesh, "data")
        self.mesh = mesh
        self.tensor_parallel = is_tensor_parallel(mesh)  # DTensor parameters (``shard_params``)
        self.input_preprocess = input_preprocess or (lambda x: x.to(torch.float32))

    def _aggregate(self, params, images):
        with span("collect.preprocess", self.device):
            x = self.input_preprocess(images)
        with span("collect.forward", self.device):
            if self.tensor_parallel:
                with tensor_parallel_region():
                    _, taps = self.model.apply(params, x, self.layer_names)
                    taps = {name: full_tensor(t) for name, t in taps.items()}
            else:
                _, taps = self.model.apply(params, x, self.layer_names)
        return {name: self.aggregation_fn(taps[name]).to(torch.float32) for name in self.layer_names}

    def infer_n_latents(self, params, dataset) -> dict[str, int]:
        """Per-layer component counts from a one-image forward (:meth:`sentinel_states`)."""
        probe = torch.from_numpy(np.ascontiguousarray(get_image(dataset, 0)[None])).to(self.device)
        with torch.inference_mode():
            aggs = self._aggregate(params, probe)
        return {name: int(a.shape[-1]) for name, a in aggs.items()}

    def _step(self, states, params, images, start: int, n_total: int):
        """Forward, aggregate, mask padding to −inf, merge into the top-k (``states`` None: sized from this batch)."""
        b = images.shape[0]
        sample_ids = start + torch.arange(b, dtype=torch.int32, device=self.device)
        valid = (sample_ids < n_total)[:, None]
        aggs = self._aggregate(params, images)
        if states is None:
            states = self._init_states({name: int(a.shape[-1]) for name, a in aggs.items()})
        with span("collect.topk", self.device):
            return {
                name: topk_update(states[name], torch.where(valid, aggs[name], -torch.inf), sample_ids)
                for name in self.layer_names
            }

    @staticmethod
    def _check_id_range(n: int, id_offset: int):
        """Sample ids are int32 on the device; ids ≥ 2^31 would wrap."""
        if id_offset + n > np.iinfo(np.int32).max:
            raise ValueError(
                f"dataset of {n} samples at id offset {id_offset} exceeds the "
                f"int32 sample-id range ({np.iinfo(np.int32).max}); split the "
                "sweep into sub-2^31 shards (id_offset keeps ids global)"
            )

    def _init_states(self, n_latents: dict[str, int]):
        with span("collect.init"):
            return {name: init_topk(c, self.n_collect, self.device) for name, c in n_latents.items()}

    def sentinel_states(self, params, dataset) -> dict[str, TopKState]:
        """Full-shape (C, k) states of sentinels, sized by a one-image forward of ``dataset``.

        For a process of a multi-process sweep whose shard is empty: it
        sweeps nothing, yet contributes states of every other process's
        shape to the all-gather.
        """
        return self._init_states(self.infer_n_latents(params, dataset))

    def _gather_states(self, states):
        """Every data rank's states stacked to (W, C, k) values and ids."""
        return {name: TopKState(values=all_gather(st.values, self.group), ids=all_gather(st.ids, self.group))
                for name, st in states.items()}

    def _finalize(self, states):
        """The merged (C, k) states, the same on every rank (one shard: the states themselves)."""
        if self.n_shards == 1:
            return states
        return {name: topk_merge(st) for name, st in self._gather_states(states).items()}

    # ------------------------------------------------------------ checkpoints
    def save_checkpoint(self, directory, states, next_start: int):
        """Persist the running top-k states; a resumed sweep starts at ``next_start``.

        ``progress.json`` is written last: it commits the state files and
        any embedding chunk written before it. ``states`` None (an embed-only
        sweep): ``progress.json`` holds ``next_start`` alone. Under a data
        mesh every rank calls this: the states are gathered to (W, C, k),
        global rank 0 writes, and all ranks meet at a barrier.
        """
        if states is not None and self.n_shards > 1:
            states = self._gather_states(states)
        if is_writer(self.mesh):
            directory = Path(directory)
            directory.mkdir(parents=True, exist_ok=True)
            progress = {"next_start": int(next_start)}
            if states is not None:
                for name, st in states.items():
                    safetensors_io.save_file({"values": st.values.to(torch.bfloat16), "ids": st.ids.to(torch.int32)},
                                             directory / f"state-{name}.safetensors")
                progress["layers"] = list(states)
            (directory / "progress.json").write_text(json.dumps(progress))
        if self.mesh is not None:
            barrier()

    def load_checkpoint(self, directory):
        """``(states on the engine's device, next_start)``, or None without a checkpoint.

        The states are None where ``progress.json`` names no layers (an
        embed-only sweep's). Under a data mesh of ``W`` ranks the files hold
        (W, C, k) states (either package's meshed layout) and each rank
        takes its own.
        """
        directory = Path(directory)
        progress = directory / "progress.json"
        if not progress.exists():
            return None
        meta = json.loads(progress.read_text())
        if "layers" not in meta:
            return None, int(meta["next_start"])
        states = {}
        for name in meta["layers"]:
            t = safetensors_io.load_file(directory / f"state-{name}.safetensors")
            values, ids = t["values"], t["ids"]
            want = 3 if self.n_shards > 1 else 2
            if values.ndim != want or (want == 3 and values.shape[0] != self.n_shards):
                raise ValueError(f"checkpoint {directory} holds {tuple(values.shape)} states for layer {name}; "
                                 f"a sweep over {self.n_shards} data shard(s) resumes from "
                                 f"{'(W=%d, C, k)' % self.n_shards if want == 3 else '(C, k)'} states")
            if want == 3:
                values, ids = values[self.shard], ids[self.shard]
            states[name] = TopKState(values=values.to(self.device), ids=ids.to(self.device))
        return states, int(meta["next_start"])

    @staticmethod
    def _store_embed_chunk(directory, row_start: int, chunk: np.ndarray) -> None:
        """Persist embedding rows [row_start, row_start + len(chunk))."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        safetensors_io.save_file({"embeds": torch.from_numpy(np.ascontiguousarray(chunk, np.float32))},
                                 directory / f"embeds-{row_start:012d}.safetensors")

    @staticmethod
    def _load_embed_chunks(directory, n_rows: int) -> list[np.ndarray]:
        """Persisted embedding chunks covering exactly rows [0, n_rows).

        Chunks are written before ``progress.json`` commits ``next_start``, so
        rows up to ``n_rows`` must be there without a gap (a gap means the
        directory mixes sweeps). Rows past ``n_rows`` are dropped: a crash
        between a chunk write and its commit leaves a stale trailing chunk
        whose samples the resumed sweep computes again.
        """
        directory = Path(directory)
        chunks, covered = [], 0
        for fpath in sorted(directory.glob("embeds-*.safetensors")):
            if covered >= n_rows:
                logger.warning("dropping uncommitted embedding chunk %s (rows >= %d)", fpath.name, n_rows)
                break
            row_start = int(fpath.stem.split("-")[1])
            if row_start != covered:
                raise RuntimeError(
                    f"embedding checkpoint gap: expected rows from {covered}, found {fpath.name} in {directory}"
                )
            chunk = safetensors_io.load_file(fpath)["embeds"].numpy()
            if covered + chunk.shape[0] > n_rows:
                logger.warning("truncating embedding chunk %s to the committed row count %d", fpath.name, n_rows)
                chunk = chunk[: n_rows - covered]
            chunks.append(chunk)
            covered += chunk.shape[0]
        if covered < n_rows:
            raise RuntimeError(
                f"embedding checkpoint covers {covered} rows but progress says {n_rows} were collected ({directory})"
            )
        return chunks

    @staticmethod
    def clear_checkpoint(directory) -> None:
        """Remove a finished sweep's checkpoint files, and the directory when nothing else is in it."""
        directory = Path(directory)
        if not directory.is_dir():
            return
        for fpath in [*directory.glob("state-*.safetensors"), *directory.glob("embeds-*.safetensors")]:
            fpath.unlink(missing_ok=True)
        (directory / "progress.json").unlink(missing_ok=True)
        try:
            directory.rmdir()
        except OSError:
            pass  # other files are there: leave the directory

    # -------------------------------------------------------------------- run
    def _sweep(self, dataset, batch_size: int, device, *, host_thread: bool = False, collect: bool = True,
               params=None, embed_fn: Callable | None = None, id_offset: int = 0, checkpoint_dir=None,
               checkpoint_every: int = 0):
        """The batch loop of every sweep; returns ``(final states or None, EmbedSink or None)``.

        This rank's rows of each batch go to ``device`` (read on a host thread
        with ``host_thread``), step the top-k states with ``collect`` and feed
        ``embed_fn``'s rows (all-gathered under a data mesh) to an
        :class:`EmbedSink`; every ``checkpoint_every`` batches both commit.
        """
        n = len(dataset)
        if collect:
            self._check_id_range(n, id_offset)
        loaded = self.load_checkpoint(checkpoint_dir) if checkpoint_dir is not None else None
        states, resume_start = loaded if loaded is not None else (None, 0)
        if loaded is not None:
            if collect and states is None:
                raise ValueError(f"checkpoint {checkpoint_dir} holds no top-k states to resume a Collect sweep")
            logger.info("Resuming sweep from sample %d", resume_start)
        sink = None
        if embed_fn is not None:
            sink = EmbedSink(self._load_embed_chunks(checkpoint_dir, resume_start) if loaded else [], resume_start)
        # iter_batches refuses a batch size the data-parallel degree does not divide
        rows = iter_batches(dataset, batch_size, start_index=resume_start, part=(self.shard, self.n_shards))
        batches_done = 0
        with torch.inference_mode():
            for images, start, _ in device_prefetch_batches(prefetch_batches(rows) if host_thread else rows, device):
                if collect:
                    states = self._step(states, params, images, start + id_offset, n + id_offset)
                if sink is not None:
                    emb = embed_fn(images)
                    sink.add(emb if self.n_shards == 1 else all_gather(emb, self.group).flatten(0, 1))
                batches_done += 1
                if checkpoint_dir is not None and checkpoint_every > 0 and batches_done % checkpoint_every == 0:
                    next_start = start - self.shard * (batch_size // self.n_shards) + batch_size  # the next batch
                    if sink is not None:
                        first, chunk = sink.commit(next_start)
                        if is_writer(self.mesh):
                            self._store_embed_chunk(checkpoint_dir, first, chunk)
                    self.save_checkpoint(checkpoint_dir, states, next_start)
            return (self._finalize(states) if collect else None), sink

    def run(self, params, dataset, batch_size: int, *, checkpoint_dir=None, checkpoint_every: int = 0,
            id_offset: int = 0):
        """Stream the dataset; returns ``({layer: TopKState}, n_samples)``.

        With ``checkpoint_dir`` and ``checkpoint_every`` (batches) the states
        persist every that many batches, and a sweep that finds a checkpoint
        there resumes from it.
        """
        n = len(dataset)
        if n == 0:
            return {name: init_topk(1, self.n_collect, self.device) for name in self.layer_names}, 0
        states, _ = self._sweep(dataset, batch_size, self.device, params=params, id_offset=id_offset,
                                checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)
        return states, n

    def run_fused(
        self,
        params,
        dataset,
        batch_size: int,
        embed_fn: Callable,
        *,
        checkpoint_dir=None,
        checkpoint_every: int = 0,
        id_offset: int = 0,
    ):
        """Single-pass Collect + Embed: one upload per image feeds both models.

        ``embed_fn(raw_device_batch) -> (B, D)`` embeds the raw uploaded batch
        (it preprocesses for its own model). Embeddings drain to host memory
        every ``EMBED_FLUSH_BYTES`` (:class:`EmbedSink`). With
        ``checkpoint_dir`` and ``checkpoint_every`` (batches) both halves
        persist, the embedding chunk before ``progress.json`` commits it, and
        an interrupted sweep resumes from the last commit.

        Under a data mesh ``embed_fn`` embeds this rank's rows only, and
        each batch's rows are all-gathered in global order before they
        reach the sink.

        Returns ``({layer: TopKState}, embeds (N, D) float32 numpy, n)``.
        """
        n = len(dataset)
        if n == 0:
            states = {name: init_topk(1, self.n_collect, self.device) for name in self.layer_names}
            return states, np.zeros((0, 1), np.float32), 0
        states, sink = self._sweep(dataset, batch_size, self.device, params=params, embed_fn=embed_fn,
                                   id_offset=id_offset, checkpoint_dir=checkpoint_dir,
                                   checkpoint_every=checkpoint_every)
        return states, sink.table(n), n

    def run_embed(self, dataset, batch_size: int, embed_fn: Callable, *, device, checkpoint_dir=None,
                  checkpoint_every: int = 0) -> np.ndarray:
        """Embed-only sweep: every sample of ``dataset`` once → (N, D) float32 numpy.

        ``embed_fn(raw_device_batch) -> (B, D)`` runs on ``device`` (the
        foundation model's), batches read on a host thread ahead of the
        upload. Rows drain, checkpoint (``progress.json`` holding
        ``next_start`` alone) and all-gather under a mesh as in :meth:`run_fused`.
        """
        _, sink = self._sweep(dataset, batch_size, device, host_thread=True, collect=False, embed_fn=embed_fn,
                              checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)
        return sink.table(len(dataset))


__all__ = ["CollectEngine", "TopKState"]
