"""Port parity: the int8 towers (CLIP ViT and text, SigLIP2, MobileCLIP) against the JAX package.

The bounds, controls and helpers are ``test_torch_quant_models.py``'s (its
docstring gives the measurements): the transformer towers' embeddings
within 1e-5 relative (L2) of the JAX int8 towers' with the float tower as
the control; MobileCLIP's int8 sites replayed exactly on the JAX tower's
own inputs, end to end within 0.06 with wrong-channel scales as the
control; ≥ 0.995 cosine against the float tower.
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import semanticlens_tpu.foundation_models.mobileclip as jmc
from semanticlens_tpu.foundation_models import clip as jclip
from semanticlens_tpu.foundation_models import siglip as jsig
from semanticlens_tpu_torch.foundation_models import clip as tclip
from semanticlens_tpu_torch.foundation_models import create
from semanticlens_tpu_torch.foundation_models import mobileclip as tmc
from semanticlens_tpu_torch.foundation_models import siglip as tsig
from semanticlens_tpu_torch.ops.quant import QuantizedTensor

from test_torch_quant_models import (CLIP_J, CLIP_T, CLIP_TX, CLIP_V, CONV_E2E_BOUND, FLOAT_COSINE,
                                     TRANSFORMER_BOUND, _cos, _int8_keys_equal, _perturbed, _recording, _rel,
                                     _replay_in_port, _wrong_channel_scales)

torch.set_num_threads(2)

# --------------------------------------------------------------------------- CLIP
IMAGES = np.random.default_rng(2).normal(size=(6, 32, 32, 3)).astype(np.float32)


def _encode_pair(encode_image, encode_text, params, cfg, tokens, images=IMAGES):
    return (encode_image(params, cfg, torch.from_numpy(images)).numpy(),
            encode_text(params, cfg, torch.from_numpy(tokens)).numpy())


def _check_tower(t_int8, j_int8, t_float, include_text):
    """Embeddings (image, text) of the port's int8 tower against JAX's, its float tower as the control."""
    for i, what in enumerate(("image", "text")):
        if what == "text" and not include_text:
            np.testing.assert_array_equal(t_int8[i], t_float[i])  # the text tower stays float
            continue
        assert _rel(t_int8[i], j_int8[i]) <= TRANSFORMER_BOUND, what
        assert _rel(t_float[i], j_int8[i]) > TRANSFORMER_BOUND, what
        assert _cos(t_int8[i], t_float[i]).min() >= FLOAT_COSINE, what


@pytest.mark.parametrize("include_text", [False, True], ids=["image", "image_and_text"])
def test_openclip_int8_against_jax(include_text):
    np_params = _perturbed(tclip.init_clip_params_jax_layout(0, CLIP_T), 1)
    fm = tclip.OpenClip("ViT-B-32", cfg=CLIP_T, jax_params=np_params, dtype=torch.float32, device="cpu",
                        quantize="int8")
    ff = tclip.OpenClip("ViT-B-32", cfg=CLIP_T, jax_params=np_params, dtype=torch.float32, device="cpu")
    assert fm.name == "OpenClip(ViT-B-32)-int8" and ff.name == "OpenClip(ViT-B-32)"
    assert repr(fm) == "OpenClip(url='ViT-B-32', preset=ViT-B-32, quantize='int8')"
    params = tclip.quantize_clip_params(fm.params, CLIP_T, include_text=True) if include_text else fm.params
    jparams = jclip.quantize_clip_params({k: jnp.asarray(v) for k, v in np_params.items()}, CLIP_J,
                                         include_text=include_text)
    _int8_keys_equal(params, jparams)
    assert all(not isinstance(v, QuantizedTensor) for k, v in params.items() if k.startswith("transformer.")) \
        != include_text
    tokens = np.random.default_rng(3).integers(1, 99, size=(5, 12))
    t_int8 = _encode_pair(tclip.vit_encode_image, tclip.clip_encode_text, params, CLIP_T, tokens)
    j_int8 = (np.asarray(jclip.vit_encode_image(jparams, CLIP_J, jnp.asarray(IMAGES))),
              np.asarray(jclip.clip_encode_text(jparams, CLIP_J, jnp.asarray(tokens))))
    t_float = _encode_pair(tclip.vit_encode_image, tclip.clip_encode_text, ff.params, CLIP_T, tokens)
    _check_tower(t_int8, j_int8, t_float, include_text)
    # the class's own entry points run the int8 tower
    np.testing.assert_array_equal(fm.encode_image(torch.from_numpy(IMAGES)).numpy(),
                                  tclip.vit_encode_image(fm.params, CLIP_T, torch.from_numpy(IMAGES)).numpy())
    assert fm.encode_text(fm.tokenize(["a photo of a dog"])).shape == (1, 64)  # one prompt: 1 row padded to 17


def test_openclip_rn_tower_warns_and_stays_float(caplog):
    cfg = tclip.CLIPConfig(embed_dim=32, vision=tclip.VisionCfg(kind="resnet", image_size=64, layers=(1, 1, 1, 1),
                                                                resnet_width=8),
                           text=tclip.TextCfg(**CLIP_TX))
    with caplog.at_level(logging.WARNING, logger=tclip.__name__):
        fm = tclip.OpenClip("RN50", cfg=cfg, dtype=torch.float32, device="cpu", quantize="int8")
    assert "left in float" in caplog.text
    assert not any(isinstance(v, QuantizedTensor) for v in fm.params.values())
    assert fm.name.endswith("-int8")  # the request is in the cache key all the same, as in the JAX package


def test_create_passes_quantize_and_unknown_modes_are_refused():
    fm = create("ViT-B-32", quantize="int8", cfg=CLIP_T, dtype=torch.float32, device="cpu")
    assert isinstance(fm, tclip.OpenClip) and fm.quantize == "int8" and fm.name.endswith("-int8")
    sig = create("siglip2", quantize="int8", cfg=SIG_T, dtype=torch.float32, device="cpu")
    assert isinstance(sig, tsig.SigLipV2) and repr(sig).endswith("quantize='int8')")
    mob = create("mobileclip-s1", quantize="int8", cfg=MOB_T, dtype=torch.float32, device="cpu")
    assert isinstance(mob, tmc.ClipMobile) and mob.name == "ClipMobile(MobileCLIP-S1)-int8"
    for cls, kw in ((tclip.OpenClip, dict(cfg=CLIP_T)), (tsig.SigLipV2, dict(cfg=SIG_T)),
                    (tmc.ClipMobile, dict(cfg=MOB_T))):
        with pytest.raises(ValueError, match="only 'int8'"):
            cls(quantize="fp8", device="cpu", **kw)


# --------------------------------------------------------------------------- SigLIP
SIG_KW = dict(embed_dim=64, image_size=32, patch_size=8, vision_width=64, vision_layers=3, vision_heads=4,
              text_width=64, text_layers=2, text_heads=4, vocab_size=1000, context_length=16)
SIG_J, SIG_T = jsig.SigLIPConfig(**SIG_KW), tsig.SigLIPConfig(**SIG_KW)


@pytest.mark.parametrize("include_text", [False, True], ids=["image", "image_and_text"])
def test_siglip_int8_against_jax(include_text):
    np_params = _perturbed(tsig.init_siglip_params_jax_layout(0, SIG_T), 1)
    fm = tsig.SigLipV2(cfg=SIG_T, jax_params=np_params, dtype=torch.float32, device="cpu", quantize="int8")
    ff = tsig.SigLipV2(cfg=SIG_T, jax_params=np_params, dtype=torch.float32, device="cpu")
    assert fm.name == f"SigLipV2({tsig.SigLipV2.URL})-int8" and "int8" not in ff.name + repr(ff)
    assert repr(fm) == f"SigLipV2(url='{tsig.SigLipV2.URL}', quantize='int8')"
    assert tsig.SIGLIP_DENSE_SUFFIXES == jsig.SIGLIP_DENSE_SUFFIXES
    params = tsig.quantize_siglip_params(fm.params, include_text=True) if include_text else fm.params
    jparams = jsig.quantize_siglip_params({k: jnp.asarray(v) for k, v in np_params.items()},
                                          include_text=include_text)
    _int8_keys_equal(params, jparams)
    assert not isinstance(params["visual.attn_pool.kv.weight"], QuantizedTensor)  # the MAP head stays float
    tokens = np.random.default_rng(3).integers(1, 999, size=(5, 16))
    t_int8 = _encode_pair(tsig.siglip_encode_image, tsig.siglip_encode_text, params, SIG_T, tokens)
    j_int8 = (np.asarray(jsig.siglip_encode_image(jparams, SIG_J, jnp.asarray(IMAGES))),
              np.asarray(jsig.siglip_encode_text(jparams, SIG_J, jnp.asarray(tokens))))
    t_float = _encode_pair(tsig.siglip_encode_image, tsig.siglip_encode_text, ff.params, SIG_T, tokens)
    _check_tower(t_int8, j_int8, t_float, include_text)


# --------------------------------------------------------------------------- MobileCLIP
MOB_KW = dict(embed_dim=32, image_size=64, depths=(1, 2, 2, 1), dims=(16, 32, 64, 128), attn_heads=2)
MOB_TX = dict(context_length=10, vocab_size=50, width=32, heads=2, layers=2)
MOB_J = jmc.MobileCLIPConfig(**MOB_KW, text=jclip.TextCfg(**MOB_TX))
MOB_T = tmc.MobileCLIPConfig(**MOB_KW, text=tmc.TextCfg(**MOB_TX))


@pytest.mark.parametrize("include_text", [False, True], ids=["image", "image_and_text"])
def test_mobileclip_int8_against_jax(include_text, monkeypatch):
    np_params = _perturbed(tmc.init_mobileclip_params_jax_layout(0, MOB_T), 1)
    fm = tmc.ClipMobile("s1", cfg=MOB_T, jax_params=np_params, dtype=torch.float32, device="cpu", quantize="int8")
    ff = tmc.ClipMobile("s1", cfg=MOB_T, jax_params=np_params, dtype=torch.float32, device="cpu")
    assert fm.name == "ClipMobile(MobileCLIP-S1)-int8" and repr(fm) == "ClipMobile(url='MobileCLIP-S1', quantize='int8')"
    params = tmc.quantize_mobileclip_params(fm.params, include_text=True) if include_text else fm.params
    jparams = jmc.quantize_mobileclip_params({k: jnp.asarray(v) for k, v in np_params.items()},
                                             include_text=include_text)
    _int8_keys_equal(params, jparams)
    for key in ("visual.stage0.blocks.0.ffn.dw.weight", "visual.stem.0.weight", "visual.head.proj"):
        assert not isinstance(params[key], QuantizedTensor), key
    images = np.random.default_rng(2).random((2, 64, 64, 3)).astype(np.float32)
    record = []
    for op in ("conv2d", "linear"):
        monkeypatch.setattr(jmc, op, _recording(jmc, op, record))
    j_image = np.asarray(jmc.mobileclip_encode_image(jparams, MOB_J, jnp.asarray(images)))  # eager
    monkeypatch.undo()
    assert {r[0] for r in record} == {"conv2d", "linear"}
    _replay_in_port(record)
    t_image = tmc.mobileclip_encode_image(params, MOB_T, torch.from_numpy(images)).numpy()
    control = tmc.mobileclip_encode_image(_wrong_channel_scales(params), MOB_T, torch.from_numpy(images)).numpy()
    f_image = ff.encode_image(torch.from_numpy(images)).numpy()
    assert _rel(t_image, j_image) <= CONV_E2E_BOUND and _rel(control, j_image) > CONV_E2E_BOUND
    assert _cos(t_image, f_image).min() >= FLOAT_COSINE
    tokens = np.random.default_rng(3).integers(1, 49, size=(5, 10))
    t_text = tclip.clip_encode_text(params, fm._text_cfg, torch.from_numpy(tokens)).numpy()
    f_text = ff.encode_text(torch.from_numpy(tokens)).numpy()
    if include_text:
        j_text = np.asarray(jclip.clip_encode_text(jparams, jmc._TextOnly(MOB_J), jnp.asarray(tokens)))
        assert _rel(t_text, j_text) <= TRANSFORMER_BOUND and _rel(f_text, j_text) > TRANSFORMER_BOUND
        assert _cos(t_text, f_text).min() >= FLOAT_COSINE
    else:
        np.testing.assert_array_equal(t_text, f_text)


# --------------------------------------------------------------------------- mesh
def test_quantized_tower_under_a_world1_mesh_equals_the_plain_one(tmp_path):
    """One gloo rank (``parallel.launch.spawn``): ``OpenClip(quantize="int8", mesh=data_mesh())`` against
    the same tower without a mesh, image and text embeddings equal exactly."""
    from semanticlens_tpu_torch.parallel import launch

    import torch_mesh_ranks as ranks

    np.savez(tmp_path / "weights.npz", **tclip.init_clip_params_jax_layout(0, CLIP_T))
    launch.spawn(ranks.int8_tower_ranks, 1, tmp_path / "work", args=(str(tmp_path), CLIP_V, CLIP_TX), timeout_s=120)
    with np.load(tmp_path / "int8_mesh.npz") as out:
        assert {k for k in out.files} == {"mesh/image", "plain/image", "mesh/text", "plain/text"}
        for what in ("image", "text"):
            np.testing.assert_array_equal(out[f"mesh/{what}"], out[f"plain/{what}"])
        assert out["mesh/image"].shape == (5, 64)
