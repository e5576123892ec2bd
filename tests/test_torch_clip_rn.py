"""Port parity of CLIP's ModifiedResNet image tower (RN50 family) against the JAX package.

A cut-down RN config (stem width 8, one block per stage, 64 px, embed 16)
with random weights drawn in the JAX layout, carried across by
``convert.clip_params_from_jax`` (BN statistics made non-trivial), must give
the JAX package's ``resnet_encode_image`` within atol 2e-4 in float32 (the
towers' tolerance). The RN50/RN101 parameter specs must equal JAX's name for
name and shape; open_clip state dicts load from memory and from
``.safetensors``/``.npz`` files the test writes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu.foundation_models import clip as jclip
from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch.foundation_models import clip as tclip
from semanticlens_tpu_torch.models.layers import avg_pool
from semanticlens_tpu_torch.utils import safetensors_io

torch.set_num_threads(2)

TEXT_J = jclip.TextCfg(context_length=12, vocab_size=50, width=32, heads=2, layers=2)
TEXT_T = tclip.TextCfg(context_length=12, vocab_size=50, width=32, heads=2, layers=2)
TINY_J = jclip.CLIPConfig(embed_dim=16, vision=jclip.VisionCfg(kind="resnet", image_size=64, layers=(1, 1, 1, 1),
                                                                resnet_width=8), text=TEXT_J)
TINY_T = tclip.CLIPConfig(embed_dim=16, vision=tclip.VisionCfg(kind="resnet", image_size=64, layers=(1, 1, 1, 1),
                                                                resnet_width=8), text=TEXT_T)


def _jax_layout_params(seed=0):
    """Random weights in the JAX layout with non-trivial BN statistics and affine terms."""
    params = tclip.init_clip_params_jax_layout(seed, TINY_T)
    rng = np.random.default_rng(seed + 1)
    for name, value in params.items():
        if name.endswith("running_var"):
            params[name] = rng.uniform(0.5, 2.0, value.shape).astype(np.float32)
        elif name.endswith("running_mean") or (".bn" in name or ".downsample.1." in name):
            params[name] = (value + rng.normal(0, 0.1, value.shape)).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def towers():
    params = _jax_layout_params()
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tfm = tclip.OpenClip("RN50", jax_params=params, dtype=torch.float32, device="cpu", cfg=TINY_T)
    return params, jparams, tfm


@pytest.mark.parametrize("batch", [1, 3])
def test_encode_image_matches_jax(towers, batch):
    _, jparams, tfm = towers
    x = np.random.default_rng(batch).normal(size=(batch, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jclip.resnet_encode_image(jparams, TINY_J, jnp.asarray(x)))
    got = tfm.encode_image(torch.from_numpy(x)).numpy()
    assert got.shape == (batch, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert tclip.resnet_trunk(tfm.params, TINY_T, torch.from_numpy(x)).shape == (batch, 256, 2, 2)


def test_preprocess_and_encode_from_uint8_matches_jax(towers):
    """The FM's own preprocess (resize 80→64, CLIP normalization) then the tower, in both packages."""
    _, jparams, tfm = towers
    jfm = jclip.OpenClip("RN50", params=jparams, dtype=jnp.float32)
    jfm.cfg = TINY_J
    images = np.random.default_rng(5).integers(0, 256, size=(2, 80, 96, 3), dtype=np.uint8)
    want = np.asarray(jfm.encode_image(jfm.preprocess(images)))
    got = tfm.encode_image(tfm.preprocess(images)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_convert_carries_every_rn_parameter(towers):
    """convert.clip_params_from_jax relayouts convs (HWIO → OIHW) and the attention pool's projections
    ((in, out) → (out, in)); BN vectors and the positional table pass through."""
    params, _, tfm = towers
    torch_sd = convert.clip_params_from_jax(params)
    for name, arr in params.items():
        t = torch_sd[name].numpy()
        if arr.ndim == 4:
            np.testing.assert_array_equal(t, arr.transpose(3, 2, 0, 1), err_msg=name)
        elif name.endswith("weight") and arr.ndim == 2 and "embedding" not in name:
            np.testing.assert_array_equal(t, arr.T, err_msg=name)
        else:
            np.testing.assert_array_equal(t, arr, err_msg=name)
    assert set(tfm.params) == set(params)


@pytest.mark.parametrize("preset", ["RN50", "RN101"])
def test_param_specs_equal_jax(preset):
    t = [(n, tuple(s)) for n, s, _ in tclip.clip_param_specs(tclip.CLIP_PRESETS[preset])]
    j = [(n, tuple(s)) for n, s, _ in jclip.clip_param_specs(jclip.CLIP_PRESETS[preset])]
    assert t == j
    cfg = tclip.CLIP_PRESETS[preset]
    assert cfg.embed_dim == jclip.CLIP_PRESETS[preset].embed_dim == (1024 if preset == "RN50" else 512)
    assert dict(t)["visual.attnpool.positional_embedding"] == (50, 2048)


def test_bf16_tower_keeps_norms_float32(towers):
    params, _, _ = towers
    fm = tclip.OpenClip("RN50", jax_params=params, dtype=torch.bfloat16, device="cpu", cfg=TINY_T)
    assert fm.params["visual.bn1.running_var"].dtype == torch.float32
    assert fm.params["visual.layer3.0.downsample.1.bias"].dtype == torch.float32
    assert fm.params["visual.layer1.0.conv2.weight"].dtype == torch.bfloat16
    assert fm.params["visual.attnpool.q_proj.weight"].dtype == torch.bfloat16
    out = fm.encode_image(torch.zeros(1, 64, 64, 3))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_avg_pool_matches_jax():
    from semanticlens_tpu.models.layers import avg_pool as javg

    x = np.random.default_rng(0).normal(size=(2, 6, 8, 5)).astype(np.float32)
    for window, stride, padding in ((2, 2, 0), (3, 1, 1), (2, 1, 0)):
        want = np.asarray(javg(jnp.asarray(x), window=window, stride=stride, padding=padding))
        got = avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), window=window, stride=stride, padding=padding)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-6)


def _torch_state_dict(params):
    return {k: v.clone() for k, v in convert.clip_params_from_jax(params).items()}


def test_load_openclip_state_dict_checks_names_and_shapes(towers):
    params, _, _ = towers
    sd = _torch_state_dict(params)
    sd["attn_mask"] = torch.zeros(3)  # extra entries are ignored
    loaded = tclip.load_openclip_state_dict(TINY_T, sd)
    assert set(loaded) == {n for n, _, _ in tclip.clip_param_specs(TINY_T)}
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in loaded.values())
    # The JAX loader on the same torch state dict gives the JAX layout of the same tensors.
    jloaded = jclip.load_openclip_state_dict(TINY_J, {k: v.numpy() for k, v in sd.items()})
    for name, arr in params.items():
        np.testing.assert_array_equal(np.asarray(jloaded[name]), arr, err_msg=name)
    missing = {k: v for k, v in sd.items() if k != "visual.layer4.0.bn3.running_mean"}
    with pytest.raises(KeyError, match="visual.layer4.0.bn3.running_mean"):
        tclip.load_openclip_state_dict(TINY_T, missing)
    bad = dict(sd, **{"visual.attnpool.q_proj.weight": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="visual.attnpool.q_proj.weight"):
        tclip.load_openclip_state_dict(TINY_T, bad)


@pytest.mark.parametrize("suffix", [".safetensors", ".npz"])
def test_checkpoint_argument_loads_files(towers, tmp_path, suffix):
    """``OpenClip(checkpoint=path)`` gives the same tower as the same weights passed in memory."""
    params, _, tfm = towers
    sd = _torch_state_dict(params)
    path = tmp_path / f"rn{suffix}"
    if suffix == ".safetensors":
        safetensors_io.save_file(sd, path)
    else:
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    fm = tclip.OpenClip("RN50", checkpoint=path, dtype=torch.float32, device="cpu", cfg=TINY_T)
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 64, 64, 3)).astype(np.float32))
    torch.testing.assert_close(fm.encode_image(x), tfm.encode_image(x), atol=0, rtol=0)
    fm2 = tclip.OpenClip("RN50", checkpoint=sd, dtype=torch.float32, device="cpu", cfg=TINY_T)
    torch.testing.assert_close(fm2.encode_image(x), tfm.encode_image(x), atol=0, rtol=0)
    with pytest.raises(ValueError, match="Unsupported checkpoint"):
        tclip.OpenClip("RN50", checkpoint=tmp_path / "w.pt", device="cpu", cfg=TINY_T)


def test_rn50_preset_resolves_and_defaults_to_the_card(monkeypatch):
    assert tclip._resolve_preset("RN50-quickgelu") == "RN50" and tclip._resolve_preset("RN50x4") is None
    cfg = dataclasses.replace(TINY_T)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tclip.OpenClip("RN50", cfg=cfg)
