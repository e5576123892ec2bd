"""Datasets and batch streaming."""

from semanticlens_tpu_torch.data.dataset import ArrayDataset, Batch, iter_batches

__all__ = ["ArrayDataset", "Batch", "iter_batches"]
