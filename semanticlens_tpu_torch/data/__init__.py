"""Datasets and batch streaming."""

from semanticlens_tpu_torch.data.dataset import ArrayDataset, Batch, Subset, iter_batches, prefetch_batches

__all__ = ["ArrayDataset", "Batch", "Subset", "iter_batches", "prefetch_batches"]
