"""Datasets and batch streaming."""

from semanticlens_tpu_torch.data.dataset import (
    ArrayDataset,
    Batch,
    Subset,
    device_prefetch_batches,
    host_shard_range,
    iter_batches,
    prefetch_batches,
)
from semanticlens_tpu_torch.data.grain_adapter import GrainDataset
from semanticlens_tpu_torch.data.image_folder import ImageFolder

__all__ = ["ArrayDataset", "Batch", "GrainDataset", "ImageFolder", "Subset", "device_prefetch_batches",
           "host_shard_range", "iter_batches", "prefetch_batches"]
