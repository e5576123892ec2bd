"""Port parity of FM self-dissection (``foundation_models/dissect.py``) against the JAX package.

All five functions on cut-down ViT and RN CLIP params: one set of numpy
weights in the JAX layout goes to the JAX functions as it is and to the
port's ``OpenClip`` (torch layout, ``c_proj``/``out_proj``/``v_proj``
weights (out, in)) through ``convert``. Directions agree within atol 1e-5
(directions of norm ≈ 0.1–3); the port's directions also match a causal bump
pushed through its own tower (cos > 0.98, the JAX test's bound) and feed
``label_components``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu.foundation_models import clip as jclip
from semanticlens_tpu.foundation_models import dissect as jdis
from semanticlens_tpu_torch.foundation_models import clip as tclip
from semanticlens_tpu_torch.foundation_models import dissect as tdis

torch.set_num_threads(2)

ATOL = 1e-5
TEXT = dict(context_length=12, vocab_size=50, width=32, heads=2, layers=2)
VIT = dict(image_size=16, patch_size=8, width=32, layers=2, heads=2)
TINY_T = tclip.CLIPConfig(embed_dim=16, vision=tclip.VisionCfg(**VIT), text=tclip.TextCfg(**TEXT))
TINY_J = jclip.CLIPConfig(embed_dim=16, vision=jclip.VisionCfg(kind="vit", **VIT), text=jclip.TextCfg(**TEXT))
RN_T = tclip.CLIPConfig(embed_dim=16, vision=tclip.VisionCfg(kind="resnet", image_size=32, layers=(1, 1, 1, 1),
                                                             resnet_width=8), text=tclip.TextCfg(**TEXT))


def _pair(cfg, seed):
    params = tclip.init_clip_params_jax_layout(seed, cfg)
    rng = np.random.default_rng(seed + 1)
    for name, value in params.items():
        if ".ln_" in name or name.startswith("ln_"):  # non-trivial final LN scales
            params[name] = (value + rng.normal(0, 0.2, value.shape)).astype(np.float32)
    fm = tclip.OpenClip("RN50" if cfg.vision.kind == "resnet" else "ViT-B-32", jax_params=params,
                        dtype=torch.float32, device="cpu", cfg=cfg)
    return {k: jnp.asarray(v) for k, v in params.items()}, fm


@pytest.fixture(scope="module")
def vit():
    return _pair(TINY_T, 0)


@pytest.fixture(scope="module")
def rn():
    return _pair(RN_T, 1)


@pytest.mark.parametrize("tower, block", [("visual", 0), ("visual", 1), ("text", 0), ("text", 1)])
def test_mlp_and_head_directions_match_jax(vit, tower, block):
    jparams, fm = vit
    got = tdis.mlp_neuron_directions(fm.params, fm.cfg, block, tower=tower)
    assert got.shape == (128, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jdis.mlp_neuron_directions(jparams, TINY_J, block, tower=tower), atol=ATOL)
    heads = tdis.attention_head_directions(fm.params, fm.cfg, block, tower=tower)
    assert heads.shape == (2, 16, 16)
    np.testing.assert_allclose(heads.numpy(), jdis.attention_head_directions(jparams, TINY_J, block, tower=tower),
                               atol=ATOL)


def test_residual_directions_match_jax_and_refusals(vit):
    jparams, fm = vit
    d = np.random.default_rng(2).normal(size=(5, 32)).astype(np.float32)
    for tower in ("visual", "text"):
        np.testing.assert_allclose(tdis.residual_directions_to_embedding(fm.params, d, tower=tower).numpy(),
                                   jdis.residual_directions_to_embedding(jparams, d, tower=tower), atol=ATOL)
    with pytest.raises(ValueError, match="out of range"):
        tdis.mlp_neuron_directions(fm.params, fm.cfg, 5)
    with pytest.raises(ValueError, match="tower"):
        tdis.residual_directions_to_embedding(fm.params, np.zeros((1, 32)), tower="bogus")
    with pytest.raises(ValueError, match="directions must be"):
        tdis.residual_directions_to_embedding(fm.params, np.zeros((1, 7)))


def test_rn_attnpool_directions_match_jax(rn):
    jparams, fm = rn
    d = tdis.resnet_attnpool_neuron_directions(fm.params)
    assert d.shape == (256, 16)
    np.testing.assert_allclose(d.numpy(), jdis.resnet_attnpool_neuron_directions(jparams), atol=ATOL)
    dh = tdis.resnet_attnpool_neuron_head_directions(fm.params)
    assert dh.shape == (256, 4, 16)
    np.testing.assert_allclose(dh.numpy(), jdis.resnet_attnpool_neuron_head_directions(jparams), atol=ATOL)
    np.testing.assert_allclose(dh.sum(dim=1).numpy(), d.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        tdis.resnet_attnpool_neuron_head_directions(fm.params, head_dim=7)
    with pytest.raises(ValueError, match="transformer towers only"):
        tdis.mlp_neuron_directions(fm.params, fm.cfg, 0)


def test_direction_matches_causal_neuron_bump(vit):
    """The JAX test's check on the port's own tower: bumping one last-block neuron through the c_proj bias
    moves the embedding along its linearized direction."""
    _, fm = vit
    block, neuron = 1, 7
    d = tdis.mlp_neuron_directions(fm.params, fm.cfg, block)[neuron].numpy()
    img = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 16, 16, 3)).astype(np.float32))
    key = f"visual.transformer.resblocks.{block}.mlp.c_proj"

    def embed(eps):
        params = dict(fm.params)
        params[f"{key}.bias"] = fm.params[f"{key}.bias"] + eps * fm.params[f"{key}.weight"][:, neuron]
        return tclip.vit_encode_image(params, fm.cfg, img)[0].numpy()

    delta = embed(0.05) - embed(0.0)
    assert float(np.dot(delta, d) / (np.linalg.norm(delta) * np.linalg.norm(d) + 1e-12)) > 0.98


def test_directions_feed_label_components(vit):
    from semanticlens_tpu_torch.lens import label_components

    _, fm = vit
    dirs = tdis.mlp_neuron_directions(fm.params, fm.cfg, 1)
    vocab = ["a", "b", "c"]
    words, scores = label_components(fm, vocab, dirs, top_m=2)
    assert len(words) == dirs.shape[0] and scores.shape == (dirs.shape[0], 2)
    ve = fm.encode_text(fm.tokenize(vocab))
    best = torch.nn.functional.normalize(dirs, dim=1) @ torch.nn.functional.normalize(ve, dim=1).T
    np.testing.assert_allclose(scores[:, 0], best.max(dim=1).values.numpy(), atol=1e-5)
