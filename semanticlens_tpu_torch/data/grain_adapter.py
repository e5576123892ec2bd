"""A random-access record source as the framework's dataset.

Counterpart of ``semanticlens_tpu.data.grain_adapter``. :class:`GrainDataset`
wraps any object with ``__len__`` and ``__getitem__`` (a
``grain.RandomAccessDataSource``, a ``grain.MapDataset``, a list of
records) and an optional transform, so the engine and visualizers run
unchanged on grain-backed storage, with the global index as sample id. It
imports nothing from ``grain``.

The JAX module's ``GrainShardDataset`` (grain worker processes decoding
this host's shard) has no port: its stream needs ``grain``, which the card
machine does not have. A process's shard of a ``GrainDataset`` is
``data.Subset(ds, *grain_shard_range(len(ds)))``, and the engine's
own prefetch overlaps the decode.
"""

from __future__ import annotations

from semanticlens_tpu_torch.data.dataset import host_shard_range  # noqa: F401  (the JAX module's name)


class GrainDataset:
    """Wrap a random-access record source as a framework dataset.

    Parameters
    ----------
    source : object with ``__len__`` and ``__getitem__`` (a
        ``grain.RandomAccessDataSource``, ``grain.MapDataset``, or any
        sequence of records).
    transform : optional record → (uint8 HWC image[, label]) converter; by
        default records pass through (they must already be images or
        (image, label) tuples).
    name : cache identity.
    """

    def __init__(self, source, transform=None, name: str | None = None):
        self.source = source
        self.transform = transform
        if name is not None:
            self.name = name

    def __len__(self):
        return len(self.source)

    def __getitem__(self, idx: int):
        record = self.source[idx]
        if self.transform is not None:
            record = self.transform(record)
        return record

    def __repr__(self):
        return f"GrainDataset(n={len(self.source)}, source={type(self.source).__name__})"


def grain_shard_range(n_total: int, *, process_index: int | None = None, process_count: int | None = None):
    """``[start, stop)`` of this process's shard under grain's ``even_split``.

    Grain gives the first ``n % shard_count`` shards one extra record, a
    tiling unlike :func:`host_shard_range` (ceil per shard). Defaults to
    ``torch.distributed``'s rank and world size (0 and 1 without a process
    group).
    """
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if live else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if live else 1) if process_count is None else process_count
    base, rem = divmod(n_total, pc)
    start = pi * base + min(pi, rem)
    return start, start + base + (1 if pi < rem else 0)
