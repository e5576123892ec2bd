"""Streaming Collect engine: forward → aggregate → top-k, batch by batch on the card.

Counterpart of ``semanticlens_tpu.collect.engine`` (one device, no mesh).
Per batch: the uint8 images upload once (pinned memory, side stream), are
normalized on the device by ``input_preprocess``, run through the tapped
subject model, each tap is aggregated to (B, C), padded rows are set to −inf
and the batch is merged into the per-layer :class:`TopKState`. Sample ids
derive from the batch start and the dataset length, as in the JAX package.

``run_fused`` also embeds every uploaded batch with a foundation model, so
Collect and Embed share one upload per image.

Checkpoint and resume of the JAX engine are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import logging
from typing import Callable, Sequence

import numpy as np
import torch

from semanticlens_tpu_torch.data.dataset import device_prefetch_batches, get_image, iter_batches
from semanticlens_tpu_torch.models.base import SubjectModel
from semanticlens_tpu_torch.ops.topk import TopKState, init_topk, topk_update

logger = logging.getLogger(__name__)

# Embeddings of the fused pass stay on the device up to this many bytes and
# then drain to host memory, so a long sweep holds at most this plus one batch.
EMBED_FLUSH_BYTES = 512 * 2**20


class CollectEngine:
    """Streaming top-k collector over a dataset for a set of tapped layers.

    Parameters
    ----------
    model : SubjectModel with functional ``apply``; runs on ``model.device``.
    layer_names : taps to collect.
    aggregation_fn : reduces raw taps to (B, n_components).
    n_collect : top-k per component.
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
        input_preprocess: Callable | None = None,
    ):
        self.model = model
        self.device = model.device
        self.layer_names = tuple(layer_names)
        self.aggregation_fn = aggregation_fn
        self.n_collect = n_collect
        self.input_preprocess = input_preprocess or (lambda x: x.to(torch.float32))

    def _aggregate(self, params, images):
        _, taps = self.model.apply(params, self.input_preprocess(images), self.layer_names)
        return {name: self.aggregation_fn(taps[name]).to(torch.float32) for name in self.layer_names}

    def infer_n_latents(self, params, dataset) -> dict[str, int]:
        """Per-layer component counts from a one-image forward."""
        probe = torch.from_numpy(np.ascontiguousarray(get_image(dataset, 0)[None])).to(self.device)
        with torch.inference_mode():
            aggs = self._aggregate(params, probe)
        return {name: int(a.shape[-1]) for name, a in aggs.items()}

    def _step(self, states, params, images, start: int, n_total: int):
        """Forward, aggregate, mask padding to −inf, merge into the top-k."""
        b = images.shape[0]
        sample_ids = start + torch.arange(b, dtype=torch.int32, device=self.device)
        valid = (sample_ids < n_total)[:, None]
        aggs = self._aggregate(params, images)
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

    def _init_states(self, params, dataset):
        n_latents = self.infer_n_latents(params, dataset)
        return {name: init_topk(c, self.n_collect, self.device) for name, c in n_latents.items()}

    def run(self, params, dataset, batch_size: int, *, id_offset: int = 0):
        """Stream the dataset; returns ``({layer: TopKState}, n_samples)``."""
        n = len(dataset)
        if n == 0:
            return {name: init_topk(1, self.n_collect, self.device) for name in self.layer_names}, 0
        self._check_id_range(n, id_offset)
        states = self._init_states(params, dataset)
        with torch.inference_mode():
            for images, start, _ in device_prefetch_batches(iter_batches(dataset, batch_size), self.device):
                states = self._step(states, params, images, start + id_offset, n + id_offset)
        return states, n

    def run_fused(
        self,
        params,
        dataset,
        batch_size: int,
        embed_fn: Callable,
        *,
        id_offset: int = 0,
    ):
        """Single-pass Collect + Embed: one upload per image feeds both models.

        ``embed_fn(raw_device_batch) -> (B, D)`` embeds the raw uploaded batch
        (it preprocesses for its own model). Embeddings drain to host memory
        every ``EMBED_FLUSH_BYTES``.

        Returns ``({layer: TopKState}, embeds (N, D) float32 numpy, n)``.
        """
        n = len(dataset)
        if n == 0:
            states = {name: init_topk(1, self.n_collect, self.device) for name in self.layer_names}
            return states, np.zeros((0, 1), np.float32), 0
        self._check_id_range(n, id_offset)
        states = self._init_states(params, dataset)

        pending: list[torch.Tensor] = []
        pending_bytes = 0
        host_chunks: list[np.ndarray] = []

        def drain():
            nonlocal pending, pending_bytes
            if pending:
                host_chunks.append(torch.cat(pending).to("cpu", torch.float32).numpy())
                pending, pending_bytes = [], 0

        with torch.inference_mode():
            for images, start, _ in device_prefetch_batches(iter_batches(dataset, batch_size), self.device):
                states = self._step(states, params, images, start + id_offset, n + id_offset)
                emb = embed_fn(images)
                pending.append(emb)
                pending_bytes += emb.numel() * emb.element_size()
                if pending_bytes >= EMBED_FLUSH_BYTES:
                    drain()
        drain()
        embeds = np.concatenate(host_chunks, axis=0)[:n]
        return states, embeds, n


__all__ = ["CollectEngine", "TopKState"]
