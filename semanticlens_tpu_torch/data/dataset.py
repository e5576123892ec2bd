"""Host-side datasets, fixed-shape batch iteration and the host→device upload.

Counterpart of ``semanticlens_tpu.data.dataset``. ``iter_batches`` pads the
last short batch and marks padded rows invalid, as in the JAX package (the
collect engine masks them to −inf). :func:`device_prefetch_batches` replaces
the JAX package's threaded ``device_put``: each batch is copied into pinned
host memory and uploaded on a side CUDA stream, up to ``depth`` batches ahead
of the compute stream, which waits on each upload's event before using it.
Images keep their host dtype (uint8 goes up as uint8).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np
import torch


class Batch(NamedTuple):
    """One fixed-shape batch of host data."""

    images: np.ndarray  # (B, H, W, C)
    start_index: int  # global dataset index of row 0
    valid: np.ndarray  # (B,) bool; False for padded rows


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


def get_image(dataset, idx: int) -> np.ndarray:
    """Image at ``idx`` regardless of whether items are bare or (image, label)."""
    return np.asarray(_extract_image(dataset[idx]))


def _extract_image(item):
    if isinstance(item, (tuple, list)):
        return item[0]
    return item


def iter_batches(dataset, batch_size: int, *, start_index: int = 0) -> Iterator[Batch]:
    """Yield fixed-shape :class:`Batch` es in dataset order.

    The final short batch is zero-padded to ``batch_size`` with
    ``valid=False`` rows.
    """
    n = len(dataset)
    fast_images = getattr(dataset, "images", None)
    for start in range(start_index, n, batch_size):
        stop = min(start + batch_size, n)
        if fast_images is not None:
            block = np.asarray(fast_images[start:stop])
        else:
            block = np.stack([np.asarray(_extract_image(dataset[i])) for i in range(start, stop)])
        valid = np.ones(batch_size, bool)
        if stop - start < batch_size:
            pad = batch_size - (stop - start)
            block = np.concatenate([block, np.zeros((pad, *block.shape[1:]), block.dtype)])
            valid[stop - start :] = False
        yield Batch(images=block, start_index=start, valid=valid)


def device_prefetch_batches(batch_iter: Iterator[Batch], device: torch.device, depth: int = 2):
    """Upload batches ahead of compute; yields ``(images_on_device, start_index, valid_host)``.

    On a CUDA device each batch is pinned and copied on a side stream with
    ``non_blocking=True``; the consumer's current stream waits on the copy's
    event, and the device tensor is recorded on that stream so the caching
    allocator keeps it until the compute that reads it is done. On the CPU
    batches pass through as tensors.
    """
    if device.type != "cuda":
        for batch in batch_iter:
            yield torch.from_numpy(np.ascontiguousarray(batch.images)), batch.start_index, batch.valid
        return

    side = torch.cuda.Stream(device)
    pending: list = []

    def upload(batch: Batch):
        host = torch.from_numpy(np.ascontiguousarray(batch.images)).pin_memory()
        with torch.cuda.stream(side):
            images = host.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return images, done, batch

    def ready(item):
        images, done, batch = item
        compute = torch.cuda.current_stream(device)
        compute.wait_event(done)
        images.record_stream(compute)
        return images, batch.start_index, batch.valid

    for batch in batch_iter:
        pending.append(upload(batch))
        if len(pending) > depth:
            yield ready(pending.pop(0))
    for item in pending:
        yield ready(item)
