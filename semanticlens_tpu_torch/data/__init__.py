"""Datasets and batch streaming."""

from semanticlens_tpu_torch.data.dataset import ArrayDataset, Batch, Subset, iter_batches, prefetch_batches
from semanticlens_tpu_torch.data.image_folder import ImageFolder

__all__ = ["ArrayDataset", "Batch", "ImageFolder", "Subset", "iter_batches", "prefetch_batches"]
