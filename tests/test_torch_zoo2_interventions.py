"""Interventions on the token-stage families of the vision zoo's part two (Swin, Swin-V2, MaxViT) against JAX.

- ``causal.ablation_effects`` on one stage tap each, (B, H, W, C) as the
  JAX package's: the Δ of each ablated component equals the JAX package's
  within 1e-5 of the logits' scale, float32 on the CPU.
- A MaxViT attention sub-block tap, (B, groups, T, C), is rewritten in that
  layout: zeroing one channel there gives the JAX package's output, so the
  swap of the grid's axes back after the rewrite is the JAX one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semanticlens_tpu import causal as jcausal
from semanticlens_tpu.models import base as jbase
from semanticlens_tpu_torch import causal as tcausal
from semanticlens_tpu_torch.models import base as tbase

from test_torch_zoo2_models import zoo2_pair
from test_torch_zoo_causal import _JittedClean

torch.set_num_threads(2)

ABLATIONS = [
    ("SwinTransformer", dict(), "features.3", 56, "zero"),
    ("SwinTransformerV2", dict(), "features.5", 56, "mean"),
    ("MaxViT", dict(), "blocks.1", 224, "zero"),
]


@pytest.mark.parametrize("cls,kw,layer,size,mode", ABLATIONS, ids=[f"{c[0]}-{c[2]}-{c[4]}" for c in ABLATIONS])
def test_ablation_effects_match_jax(cls, kw, layer, size, mode):
    jm, jp, tm, tp = zoo2_pair(cls, kw)
    batch = 1 if cls == "MaxViT" else 2
    x = np.random.default_rng(2).random((batch, size, size, 3)).astype(np.float32)
    ids = [0, 3, 5]
    want = np.asarray(jcausal.ablation_effects(_JittedClean(jm), jp, layer, jnp.asarray(x), ids, mode=mode))
    with torch.no_grad():
        clean = tm.apply(tp, torch.from_numpy(x))[0].numpy()
    got = tcausal.ablation_effects(tm, tp, layer, x, ids, mode=mode).numpy()
    assert got.shape == want.shape == (3, batch, clean.shape[-1])
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(clean).max()


def test_maxvit_grid_attention_tap_is_rewritten_in_the_jax_layout():
    """Zeroing channel 7 of ``…grid_attention.attn_layer`` (a (B, groups, T, C) tap) changes the output as in the
    JAX package: the rewrite sees torchvision's hook layout, and the swap of axes back is the JAX one."""
    jm, jp, tm, tp = zoo2_pair("MaxViT", {})
    name = "blocks.2.layers.0.layers.grid_attention.attn_layer"
    x = np.random.default_rng(3).random((1, 224, 224, 3)).astype(np.float32)

    def zero7(v):
        return v.at[..., 7].set(0.0) if isinstance(v, jax.Array) else torch.cat([v[..., :7], 0 * v[..., 7:8],
                                                                                  v[..., 8:]], -1)

    def jrun(p, xx):
        with jbase.interventions({name: zero7}):
            return jm.apply(p, xx, (name,))

    want, jtaps = jax.jit(jrun)(jp, jnp.asarray(x))
    with torch.no_grad(), tbase.interventions({name: zero7}):
        got, taps = tm.apply(tp, torch.from_numpy(x), (name,))
    assert taps[name].shape == jtaps[name].shape == (1, 4, 49, 256) and not taps[name][..., 7].any()
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-5 * np.abs(np.asarray(want)).max()
