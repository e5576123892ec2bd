"""Port parity of the SigLIP towers (``foundation_models/siglip.py``) against the JAX package.

A cut-down SigLIP (width 64, 2 layers, 4 heads, 32×32 images in 8×8
patches, vocabulary 1,000, context 16) with random weights drawn in the JAX
layout (norms and biases made non-trivial), carried across by
``convert.siglip_params_from_jax``. In float32 on the CPU the image tower
(MAP head included) and the text tower (last-position pooling, non-causal)
must give the JAX package's embeddings within atol 1e-5 (embeddings of
norm ≈ 7–9; measured 1.3e-6); the bf16 towers keep cosine ≥ 0.999 to the
JAX float32 ones.
``load_siglip_state_dict`` takes a synthetic timm-named state dict as the
JAX loader does; ``SigLipV2`` keeps the JAX class's API.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu.foundation_models import siglip as jsig
from semanticlens_tpu.foundation_models.tokenizer import HashTokenizer as JHash
from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch.foundation_models import siglip as tsig

torch.set_num_threads(2)

TINY_KW = dict(embed_dim=64, image_size=32, patch_size=8, vision_width=64, vision_layers=2, vision_heads=4,
               text_width=64, text_layers=2, text_heads=4, vocab_size=1000, context_length=16)
TINY_J, TINY_T = jsig.SigLIPConfig(**TINY_KW), tsig.SigLIPConfig(**TINY_KW)
ATOL = 1e-5


def _np_params(seed=0):
    params = tsig.init_siglip_params_jax_layout(seed, TINY_T)
    rng = np.random.default_rng(seed + 1)
    for name, value in params.items():
        if value.ndim == 1:  # non-trivial norms and biases
            params[name] = (value + rng.normal(0, 0.1, value.shape)).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def towers():
    params = _np_params()
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tfm = tsig.SigLipV2(jax_params=params, dtype=torch.float32, device="cpu", cfg=TINY_T)
    return params, jparams, tfm


def _cos(a, b):
    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_specs_and_init_match_jax():
    """Names, shapes and init kinds equal JAX's; ``logit_scale`` is ln 10 (``logit_scale_siglip``)."""
    assert tsig.siglip_param_specs(TINY_T) == jsig.siglip_param_specs(TINY_J)
    assert tsig.siglip_param_specs(tsig.SIGLIP_PRESETS["ViT-B-16-SigLIP2"]) == \
        jsig.siglip_param_specs(jsig.SIGLIP_PRESETS["ViT-B-16-SigLIP2"])
    params = tsig.init_siglip_params_jax_layout(0, TINY_T)
    assert params["logit_scale"] == np.float32(np.log(10.0)) and params["logit_bias"] == 0
    assert params["visual.pos_embed"].shape == (16, 64)  # (32/8)² patches, no class token
    with pytest.raises(ValueError, match="embed_dim == vision_width"):
        tsig.siglip_param_specs(dataclasses.replace(TINY_T, embed_dim=32))


@pytest.mark.parametrize("batch", [1, 3])
def test_encode_image_matches_jax(towers, batch):
    _, jparams, tfm = towers
    x = np.random.default_rng(batch).normal(size=(batch, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jsig.siglip_encode_image(jparams, TINY_J, jnp.asarray(x)))
    got = tfm.encode_image(torch.from_numpy(x)).numpy()
    assert got.shape == (batch, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("pad_last", [False, True])
def test_encode_text_matches_jax(towers, pad_last):
    """Last-position pooling and no causal mask: tokens after position t change the pooled vector."""
    _, jparams, tfm = towers
    tokens = np.random.default_rng(3).integers(0, 1000, size=(4, 16)).astype(np.int32)
    if pad_last:
        tokens[:, 5:] = 1  # SigLipTokenizer's padding: the EOS id fills the tail
    want = np.asarray(jsig.siglip_encode_text(jparams, TINY_J, jnp.asarray(tokens)))
    got = tfm.encode_text(torch.from_numpy(tokens)).numpy()
    assert got.shape == (4, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    changed = tokens.copy()
    changed[:, 2] = (changed[:, 2] + 1) % 1000  # a token before the pooled position still moves it
    assert not np.allclose(tfm.encode_text(torch.from_numpy(changed)).numpy(), got)


def test_bf16_towers_close_to_jax_float32(towers):
    params, jparams, _ = towers
    tfm = tsig.SigLipV2(jax_params=params, dtype=torch.bfloat16, device="cpu", cfg=TINY_T)
    assert tfm.params["visual.blocks.0.attn.qkv.weight"].dtype == torch.bfloat16
    assert all(tfm.params[k].dtype == torch.float32 for k in ("visual.norm.weight", "text.head.weight", "logit_scale"))
    x = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)
    tokens = np.random.default_rng(6).integers(0, 1000, size=(2, 16)).astype(np.int32)
    assert _cos(tfm.encode_image(torch.from_numpy(x)).numpy(),
                np.asarray(jsig.siglip_encode_image(jparams, TINY_J, jnp.asarray(x)))).min() > 0.999
    assert _cos(tfm.encode_text(torch.from_numpy(tokens)).numpy(),
                np.asarray(jsig.siglip_encode_text(jparams, TINY_J, jnp.asarray(tokens)))).min() > 0.999


def _timm_state_dict(params):
    """The torch-layout (timm-named) state dict of JAX-layout params, pos_embed as (1, N, W), plus extras."""
    sd = {k: v.numpy() for k, v in convert.siglip_params_from_jax(params).items()}
    sd["visual.pos_embed"] = sd["visual.pos_embed"][None]
    sd["text.attn_mask_unused"] = np.zeros(3, np.float32)  # ignored by both loaders
    return sd


def test_load_siglip_state_dict_matches_the_jax_loader(towers):
    params, jparams, tfm = towers
    sd = _timm_state_dict(params)
    jloaded = jsig.load_siglip_state_dict(TINY_J, sd)
    tloaded = tsig.load_siglip_state_dict(TINY_T, {k: torch.from_numpy(v) for k, v in sd.items()})
    assert set(tloaded) == set(jloaded)
    back = convert.siglip_params_from_jax({k: np.asarray(v) for k, v in jloaded.items()})
    for name in tloaded:
        assert torch.equal(tloaded[name], back[name]), name
    assert tloaded["visual.pos_embed"].shape == (16, 64)
    fm = tsig.SigLipV2(params=sd, dtype=torch.float32, device="cpu", cfg=TINY_T)
    x = np.random.default_rng(8).normal(size=(2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(fm.encode_image(torch.from_numpy(x)).numpy(),
                               np.asarray(jsig.siglip_encode_image(jloaded, TINY_J, jnp.asarray(x))), atol=ATOL)
    bad = dict(sd, **{"text.head.weight": sd["text.head.weight"].T[:, :10]})
    with pytest.raises(ValueError, match="text.head.weight"):
        tsig.load_siglip_state_dict(TINY_T, bad)
    with pytest.raises(KeyError):
        tsig.load_siglip_state_dict(TINY_T, {k: v for k, v in sd.items() if k != "visual.attn_pool.latent"})


def test_checkpoint_files_load(tmp_path, towers):
    from semanticlens_tpu_torch.utils import safetensors_io

    params, _, tfm = towers
    sd = _timm_state_dict(params)
    safetensors_io.save_file({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "w.safetensors")
    np.savez(tmp_path / "w.npz", **sd)
    for name in ("w.safetensors", "w.npz"):
        fm = tsig.SigLipV2(checkpoint=tmp_path / name, dtype=torch.float32, device="cpu", cfg=TINY_T)
        for key, value in tfm.params.items():
            assert torch.equal(fm.params[key], value), key


def test_siglipv2_api_matches_jax(towers):
    """name (concept-DB caches key on it), embed_dim, context_length, repr, the preprocess at mean/std 0.5, and
    the hash fallback's ids."""
    _, jparams, tfm = towers
    jfm = jsig.SigLipV2(params=jparams, dtype=jnp.float32)
    jfm.cfg, jfm.tokenizer = TINY_J, JHash(1000, 16)
    assert tfm.name == jfm.name == "SigLipV2(hf-hub:timm/ViT-B-16-SigLIP2)"
    assert (tfm.embed_dim, tfm.context_length, repr(tfm)) == (jfm.embed_dim, jfm.context_length, repr(jfm))
    images = np.random.default_rng(9).integers(0, 256, size=(2, 40, 48, 3), dtype=np.uint8)
    pre = tfm.preprocess(images)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jfm.preprocess(images)), atol=1e-5)
    assert float(pre.min()) >= -1.0 - 1e-3 and float(pre.max()) <= 1.0 + 1e-3  # (x − 0.5) / 0.5
    np.testing.assert_allclose(tfm.encode_image(pre).numpy(), np.asarray(jfm.encode_image(jfm.preprocess(images))),
                               atol=ATOL)
    prompts = ["a photo of a dog", "cat"]
    tokens = tfm.tokenize(prompts)
    assert tokens.dtype == torch.long and tokens.shape == (2, 16)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jfm.tokenize(prompts)))
    np.testing.assert_allclose(tfm.encode_text(tokens).numpy(), np.asarray(jfm.encode_text(jfm.tokenize(prompts))),
                               atol=ATOL)


@pytest.mark.parametrize("kwargs, error, match", [({"mesh": object()}, TypeError, "DeviceMesh"),
                                                  ({"quantize": "int4"}, ValueError, "quantize")],
                         ids=["kwargs0-item 13", "kwargs1-item 14"])  # the ids from before the mesh and int8 were ported
def test_mesh_and_quantize_are_refused(kwargs, error, match):
    with pytest.raises(error, match=match):
        tsig.SigLipV2(device="cpu", cfg=TINY_T, **kwargs)
