"""Faults planted in the program under a run's timed path, for the correctness check to catch.

    with planted("sweep-half-batch"):
        ...  # set-up, window and check of a run

Each fault replaces one function of the port for the duration of the
``with`` block and restores it after:

- ``sweep-state-unchanged``: the collect step returns its top-k state
  unchanged;
- ``sweep-half-batch``: the rows past each batch's first half count as
  padding (the rest still taken);
- ``sweep-clip-embedding-altered`` / ``sweep-siglip-embedding-altered``:
  image embeddings altered where they are produced (rolled by one image /
  the first image of every batch negated);
- ``sweep-conv-activation-altered`` / ``sweep-token-activation-altered``:
  the first image's aggregated activations of every batch altered;
- ``search-state-unchanged``: the merge returns its running top-k
  unchanged;
- ``search-half-block``: each chunk's second half of the bank left out of
  the merge;
- ``search-value-altered``: the first query's values of every call moved.

``tests/test_portbench_faults.py`` plants each in a tiny cell on the CPU;
``tools/readings.py --fault`` plants one at a cell's own size.
"""

from __future__ import annotations

import contextlib

import torch


def _sweep_state_unchanged():
    from semanticlens_tpu_torch.collect import engine

    return engine, "topk_update", lambda original: (lambda state, acts, ids: state)


def _sweep_half_batch():
    from semanticlens_tpu_torch.collect.engine import CollectEngine

    def plant(step):
        def half(self, states, params, images, start, n_total):
            return step(self, states, params, images, start, min(n_total, start + images.shape[0] // 2))

        return half

    return CollectEngine, "_step", plant


def _sweep_clip_embedding_altered():
    from semanticlens_tpu_torch.foundation_models import clip

    return clip, "vit_encode_image", lambda encode: (lambda *a, **k: encode(*a, **k).roll(1, dims=0))


def _sweep_siglip_embedding_altered():
    from semanticlens_tpu_torch.foundation_models import siglip

    def plant(encode):
        def altered(*args, **kwargs):
            out = encode(*args, **kwargs)
            return torch.cat([-out[:1], out[1:]])

        return altered

    return siglip, "siglip_encode_image", plant


def _activation_altered(name: str):
    def target():
        from semanticlens_tpu_torch.ops import aggregators

        def plant(aggregate):
            def altered(tensor):
                out = aggregate(tensor).clone()
                out[0] = out[0] * 1.5 + out[0].abs().max()
                return out

            altered.__name__ = name
            return altered

        return aggregators, name, plant

    return target


def _search_state_unchanged():
    from semanticlens_tpu_torch import scores

    return scores, "_merge_topk", lambda merge: (lambda vals, idx, sim, start: (vals, idx))


def _search_half_block():
    from semanticlens_tpu_torch import scores

    def plant(merge):
        return lambda vals, idx, sim, start: merge(vals, idx, sim[:, : max(1, sim.shape[1] // 2)], start)

    return scores, "_merge_topk", plant


def _search_value_altered():
    from semanticlens_tpu_torch import scores

    def plant(search):
        def altered(queries, bank, k, **kwargs):
            vals, idx = search(queries, bank, k, **kwargs)
            return vals + 1e-3 * (torch.arange(vals.shape[0], device=vals.device) == 0)[:, None], idx

        return altered

    return scores, "topk_cosine_search", plant


FAULTS = {
    "sweep-state-unchanged": _sweep_state_unchanged,
    "sweep-half-batch": _sweep_half_batch,
    "sweep-clip-embedding-altered": _sweep_clip_embedding_altered,
    "sweep-siglip-embedding-altered": _sweep_siglip_embedding_altered,
    "sweep-conv-activation-altered": _activation_altered("aggregate_conv_mean"),
    "sweep-token-activation-altered": _activation_altered("aggregate_transformer_mean"),
    "search-state-unchanged": _search_state_unchanged,
    "search-half-block": _search_half_block,
    "search-value-altered": _search_value_altered,
}


@contextlib.contextmanager
def planted(name: str):
    """Plant the fault ``name`` for the duration of the block."""
    owner, attr, plant = FAULTS[name]()
    original = getattr(owner, attr)
    setattr(owner, attr, plant(original))
    try:
        yield
    finally:
        setattr(owner, attr, original)
