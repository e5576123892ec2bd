"""Host-side datasets, fixed-shape batch iteration and the host→device upload.

Counterpart of ``semanticlens_tpu.data.dataset``. ``iter_batches`` pads the
last short batch and marks padded rows invalid, as in the JAX package (the
collect engine masks them to −inf); a dataset may stream its own batches
(an ``iter_batches`` method) or assemble them itself (``get_batch``).
A ``get_batch`` that decodes on the card returns a CUDA tensor: it passes
through, padded on the device, with an event recorded after the work that
made it. :func:`prefetch_batches` assembles batches on a background thread.
:func:`device_prefetch_batches` replaces
the JAX package's threaded ``device_put``: each host batch is copied into
pinned host memory and uploaded on a side CUDA stream, up to ``depth``
batches ahead of the compute stream, which waits on each upload's (or
decode's) event before using it. Images keep their dtype (uint8 goes up as
uint8).
"""

from __future__ import annotations

import inspect
import queue
import threading
from typing import Iterator, NamedTuple

import numpy as np
import torch

from semanticlens_tpu_torch.utils.profiling import span


class Batch(NamedTuple):
    """One fixed-shape batch: host data, or a tensor a dataset decoded on the card."""

    images: np.ndarray | torch.Tensor  # (B, H, W, C)
    start_index: int  # global dataset index of row 0
    valid: np.ndarray  # (B,) bool; False for padded rows
    ready: torch.cuda.Event | None = None  # for CUDA images: recorded after the work that made them


class ArrayDataset:
    """In-memory dataset over a (N, H, W, C) array with optional labels.

    A ``.name`` attribute (cache identity) can be passed or assigned later.
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray | None = None, name: str | None = None):
        self.images = np.asarray(images)
        self.labels = labels
        if name is not None:
            self.name = name

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        label = self.labels[idx] if self.labels is not None else 0
        return self.images[idx], label

    def __repr__(self):
        return f"ArrayDataset(n={len(self.images)}, shape={self.images.shape[1:]})"


class Subset:
    """Contiguous [start, stop) view of a dataset (a shard of a sweep).

    Keeps the parent's fast paths (``images``, ``get_batch``) so a sliced
    sweep stays zero-copy; the cache name appends the range, since a shard
    is not the full dataset.
    """

    def __init__(self, dataset, start: int, stop: int):
        n = len(dataset)
        if not (0 <= start <= stop <= n):
            raise ValueError(f"invalid subset range [{start}, {stop}) for dataset of {n}")
        self.dataset = dataset
        self.start, self.stop = start, stop
        if hasattr(dataset, "images"):
            self.images = dataset.images[start:stop]
        if hasattr(dataset, "get_batch"):
            self.get_batch = lambda s, e: dataset.get_batch(start + s, start + e)
        if hasattr(dataset, "name"):
            self.name = f"{dataset.name}[{start}:{stop}]"

    def __len__(self):
        return self.stop - self.start

    def __getitem__(self, idx: int):
        if idx < 0 or idx >= len(self):
            raise IndexError(idx)
        return self.dataset[self.start + idx]

    def __repr__(self):
        return f"Subset({self.dataset!r}, [{self.start}:{self.stop}))"


def get_image(dataset, idx: int) -> np.ndarray:
    """Image at ``idx`` regardless of whether items are bare or (image, label)."""
    return np.asarray(_extract_image(dataset[idx]))


def _extract_image(item):
    if isinstance(item, (tuple, list)):
        return item[0]
    return item


def iter_batches(dataset, batch_size: int, *, start_index: int = 0, part: tuple[int, int] = (0, 1)
                 ) -> Iterator[Batch]:
    """Yield fixed-shape :class:`Batch` es in dataset order.

    The final short batch is zero-padded to ``batch_size`` with
    ``valid=False`` rows. ``start_index`` resumes mid-dataset at a batch
    boundary of an earlier run. A dataset with its own
    ``iter_batches(batch_size, pad_last=, start_index=)`` (the JAX
    package's protocol) produces the batches itself.

    ``part=(rank, world)`` yields only rank ``rank``'s rows of each global
    batch, rows ``[rank·B/W, (rank+1)·B/W)`` (``W`` must divide ``B``):
    the data-parallel split of the collect engine, each batch's
    ``start_index`` being its first row's global index. A dataset whose
    ``iter_batches`` takes ``part`` (``ImageFolder``) reads only those
    rows; one that does not is read whole and sliced.
    """
    rank, world = part
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} must be divisible by data-parallel degree {world}")
    custom = getattr(dataset, "iter_batches", None)
    if custom is not None and "part" in inspect.signature(custom).parameters:
        yield from custom(batch_size, pad_last=True, start_index=start_index, part=part)
        return
    if custom is not None:
        per = batch_size // world
        for b in custom(batch_size, pad_last=True, start_index=start_index):
            lo = rank * per
            yield b if world == 1 else Batch(b.images[lo : lo + per], b.start_index + lo, b.valid[lo : lo + per],
                                             getattr(b, "ready", None))
        return
    yield from assemble_batches(dataset, batch_size, start_index=start_index, part=part)


def assemble_batches(dataset, batch_size: int, *, start_index: int = 0, part: tuple[int, int] = (0, 1)
                     ) -> Iterator[Batch]:
    """The batches of :func:`iter_batches`, assembled from the dataset's images, ``get_batch`` or items.

    A CUDA tensor from ``get_batch`` stays on the card: it is padded there,
    and an event is recorded on the current stream after it. With
    ``part=(rank, world)`` only that rank's rows of each batch are read.
    """
    n = len(dataset)
    rank, world = part
    per = batch_size // world
    fast_images = getattr(dataset, "images", None)
    get_batch = getattr(dataset, "get_batch", None)
    template = None  # no rows, of the type and image shape of this rank's last block
    for start in range(start_index, n, batch_size):
        lo = min(start + rank * per, n)
        stop = min(lo + per, n)
        if stop == lo:  # a rank whose rows all lie past the end of the data: padding only
            if template is None:
                probe = get_image(dataset, 0)
                template = np.zeros((0, *probe.shape), probe.dtype)
            block = template
        elif fast_images is not None:
            block = np.asarray(fast_images[lo:stop])
        elif get_batch is not None:
            block = get_batch(lo, stop)
            if not isinstance(block, torch.Tensor):
                block = np.asarray(block)
        else:
            block = np.stack([np.asarray(_extract_image(dataset[i])) for i in range(lo, stop)])
        template = block[:0]
        valid = np.ones(per, bool)
        if stop - lo < per:
            pad = per - (stop - lo)
            if isinstance(block, torch.Tensor):
                block = torch.cat([block, block.new_zeros((pad, *block.shape[1:]))])
            else:
                block = np.concatenate([block, np.zeros((pad, *block.shape[1:]), block.dtype)])
            valid[stop - lo :] = False
        ready = None
        if isinstance(block, torch.Tensor) and block.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(block.device))
        yield Batch(images=block, start_index=start + rank * per, valid=valid, ready=ready)


def host_shard_range(n_total: int, *, process_index: int | None = None, process_count: int | None = None):
    """Contiguous ``[start, stop)`` sample range owned by this process.

    Multi-process collect (:mod:`semanticlens_tpu_torch.parallel.multihost`):
    each process sweeps its own shard, with ids kept global through
    ``id_offset``. Ranges are ``ceil(n / P)`` long, the last ones shorter
    or empty. Defaults to ``torch.distributed``'s rank and world size (0
    and 1 without a process group).
    """
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if live else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if live else 1) if process_count is None else process_count
    per = -(-n_total // pc)  # ceil
    start = min(pi * per, n_total)
    stop = min(start + per, n_total)
    return start, stop


def prefetch_batches(batch_iter: Iterator[Batch], depth: int = 2) -> Iterator[Batch]:
    """Run ``batch_iter`` on a daemon thread with a bounded queue, in order.

    Overlaps host batch assembly (and any decode) with device work; an error
    in the producer is raised in the consumer.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    errors: list[BaseException] = []

    def worker():
        try:
            for item in batch_iter:
                q.put(item)
        except BaseException as e:  # raised again in the consumer
            errors.append(e)
        finally:
            q.put(done)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            if errors:
                raise errors[0]
            return
        yield item


def device_prefetch_batches(batch_iter: Iterator[Batch], device: torch.device, depth: int = 2):
    """Upload batches ahead of compute; yields ``(images_on_device, start_index, valid_host)``.

    On a CUDA device each host batch is pinned and copied on a side stream
    with ``non_blocking=True``; a batch already on the card (decoded there)
    is not copied. Either way the consumer's current stream waits on the
    batch's event, and the device tensor is recorded on that stream so the
    caching allocator keeps it until the compute that reads it is done. On
    the CPU batches pass through as tensors.
    """
    if device.type != "cuda":
        for batch in batch_iter:
            with span("collect.upload"):
                images = torch.from_numpy(np.ascontiguousarray(batch.images))
            yield images, batch.start_index, batch.valid
        return

    side = torch.cuda.Stream(device)
    pending: list = []

    def upload(batch: Batch):
        if isinstance(batch.images, torch.Tensor) and batch.images.is_cuda:
            return batch.images, getattr(batch, "ready", None), batch
        with span("collect.upload"):
            host = torch.from_numpy(np.ascontiguousarray(batch.images)).pin_memory()
            with torch.cuda.stream(side):
                images = host.to(device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
        return images, done, batch

    def ready(item):
        images, done, batch = item
        compute = torch.cuda.current_stream(device)
        if done is not None:
            compute.wait_event(done)
        images.record_stream(compute)
        return images, batch.start_index, batch.valid

    for batch in batch_iter:
        pending.append(upload(batch))
        if len(pending) > depth:
            yield ready(pending.pop(0))
    for item in pending:
        yield ready(item)
