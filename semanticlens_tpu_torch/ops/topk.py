"""Device-resident streaming top-k state for the Collect stage.

Counterpart of ``semanticlens_tpu.ops.topk``, with the same semantics:

- values are bf16, initialized to 0.0, so negative activations never
  displace an unfilled slot; ids are initialized to −1;
- merge = concat([state, batch]) → top-k → gather ids, and state entries win
  ties. ``lax.top_k`` is stable; ``torch.topk`` promises no order among
  equal values, so the merge is a stable descending ``torch.sort`` of the
  bf16 (C, k+B) concat, cut to k.

Padded batch rows arrive as −inf (collect/engine.py) and never enter.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TopKState(NamedTuple):
    """Running top-k for one layer: (n_latents, k) values + sample ids."""

    values: torch.Tensor  # (C, k) bfloat16, descending per row
    ids: torch.Tensor  # (C, k) int32, −1 for unfilled slots


def init_topk(n_latents: int, n_collect: int, device=None) -> TopKState:
    """Fresh state: 0.0-valued slots with −1 sample ids."""
    from semanticlens_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    return TopKState(
        values=torch.zeros((n_latents, n_collect), dtype=torch.bfloat16, device=device),
        ids=torch.full((n_latents, n_collect), -1, dtype=torch.int32, device=device),
    )


def topk_update(state: TopKState, acts: torch.Tensor, sample_ids: torch.Tensor) -> TopKState:
    """Merge a (B, C) batch of aggregated activations into the running top-k.

    ``sample_ids`` is (B,) int32 global dataset indices of the batch rows.
    Returns a new state; ``state`` is left as it was.
    """
    k = state.values.shape[1]
    batch_vals = acts.t().to(torch.bfloat16)  # (C, B)
    batch_ids = sample_ids.to(torch.int32)[None, :].expand(batch_vals.shape)
    all_vals = torch.cat([state.values, batch_vals], dim=1)
    all_ids = torch.cat([state.ids, batch_ids], dim=1)
    # bf16 comparison semantics of the stored dtype, stable: earlier wins ties.
    new_vals, idx = torch.sort(all_vals, dim=1, descending=True, stable=True)
    idx = idx[:, :k]
    return TopKState(values=new_vals[:, :k].contiguous(), ids=torch.gather(all_ids, 1, idx))


def topk_merge(states: TopKState) -> TopKState:
    """Merge stacked per-shard states (values (D, C, k)) into one (C, k) state.

    Tie-break is "value desc, sample-id asc" (two stable sorts), so a
    sentinel (0.0, −1) wins an exact-0.0 tie against a real sample, as on
    the streaming path.
    """
    d, c, k = states.values.shape
    all_vals = states.values.permute(1, 0, 2).reshape(c, d * k)
    all_ids = states.ids.permute(1, 0, 2).reshape(c, d * k)
    order_by_id = torch.sort(all_ids, dim=1, stable=True).indices
    vals_i = torch.gather(all_vals, 1, order_by_id)
    ids_i = torch.gather(all_ids, 1, order_by_id)
    order_by_val = torch.sort(vals_i.float(), dim=1, descending=True, stable=True).indices[:, :k]
    return TopKState(
        values=torch.gather(vals_i, 1, order_by_val), ids=torch.gather(ids_i, 1, order_by_val)
    )


def alive_latents(state: TopKState) -> torch.Tensor:
    """Indices of latents with any non-zero collected activation."""
    mask = torch.sum(torch.abs(state.values.float()), dim=1) > 0
    return torch.nonzero(mask).flatten()


# The JAX package's standalone jitted update with a donated state; the port runs eagerly.
topk_update_jit = topk_update
