"""Aggregation functions reducing per-layer activations to (batch, components).

Counterpart of ``semanticlens_tpu.ops.aggregators``. Conv taps arrive in the
JAX package's (B, H, W, C) layout (the port's models hand them out as NHWC
views of channels_last tensors), transformer taps as (B, T, D).

Function **names** are serialized into cache filenames and must stay
identical to the JAX package and the reference — do not rename.
"""

from __future__ import annotations

import torch


def _expect_rank(tensor, ranks: tuple[int, ...], layout: str):
    if tensor.ndim not in ranks:
        raise ValueError(
            f"aggregator expects a rank-{'/'.join(map(str, ranks))} {layout} tensor, "
            f"got rank {tensor.ndim} with shape {tuple(tensor.shape)}; pick an "
            f"aggregation function matching this layer's output layout"
        )


def aggregate_conv_mean(tensor):
    """(B, H, W, C) → (B, C) by spatial mean."""
    _expect_rank(tensor, (4,), "(B, H, W, C)")
    return torch.mean(tensor, dim=(1, 2))


def aggregate_conv_sum(tensor):
    """(B, H, W, C) → (B, C) by spatial sum."""
    _expect_rank(tensor, (4,), "(B, H, W, C)")
    return torch.sum(tensor, dim=(1, 2))


def aggregate_conv_max(tensor):
    """(B, H, W, C) → (B, C) by spatial max."""
    _expect_rank(tensor, (4,), "(B, H, W, C)")
    return torch.amax(tensor, dim=(1, 2))


def aggregate_transformer_mean(tensor):
    """(B, T, D) → (B, D) by token mean."""
    _expect_rank(tensor, (3,), "(B, T, D)")
    return torch.mean(tensor, dim=1)


def aggregate_transformer_absmean(tensor):
    """(B, T, D) → (B, D) by mean of absolute values over tokens."""
    _expect_rank(tensor, (3,), "(B, T, D)")
    return torch.mean(torch.abs(tensor), dim=1)


def aggregate_transformer_max(tensor):
    """(B, T, D) → (B, D) by token max."""
    _expect_rank(tensor, (3,), "(B, T, D)")
    return torch.amax(tensor, dim=1)


def aggregate_transformer_absmax(tensor):
    """(B, T, D) → (B, D) by max of absolute values over tokens."""
    _expect_rank(tensor, (3,), "(B, T, D)")
    return torch.amax(torch.abs(tensor), dim=1)


def _dims_auto(tensor):
    if tensor.ndim == 4:
        return (1, 2)
    if tensor.ndim == 3:
        return (1,)
    _expect_rank(tensor, (3, 4), "conv or transformer")


def aggregate_sum_auto(tensor):
    """Rank-dispatching spatial/token sum: (B,H,W,C)→(B,C) or (B,T,D)→(B,D)."""
    return torch.sum(tensor, dim=_dims_auto(tensor))


def aggregate_mean_auto(tensor):
    """Rank-dispatching spatial/token mean (see :func:`aggregate_sum_auto`)."""
    return torch.mean(tensor, dim=_dims_auto(tensor))


def aggregate_max_auto(tensor):
    """Rank-dispatching spatial/token max (see :func:`aggregate_sum_auto`)."""
    return torch.amax(tensor, dim=_dims_auto(tensor))


def aggregate_transformer_last_token(tensor):
    """(B, T, D) → (B, D): the final token position (causal-LM summary).

    Left-pad variable-length batches so position T−1 is every sequence's
    final real token.
    """
    _expect_rank(tensor, (3,), "(B, T, D)")
    return tensor[:, -1]


def get_aggregate_transformer_special_token(token_position: int):
    """Factory: extract one token position, e.g. 0 for a CLS token.

    The returned function keeps a stable ``__name__`` (it keys the on-disk
    cache), parameterized by the token position.
    """

    def aggregate_transformer_special_token(tensor):
        _expect_rank(tensor, (3,), "(B, T, D)")
        return tensor[:, token_position]

    return aggregate_transformer_special_token
