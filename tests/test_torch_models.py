"""Port parity: subject model and CLIP towers against the JAX package.

One set of numpy weights (the port's seeded init, drawn in the JAX layout)
goes to the JAX model as it is and to the port through ``convert.py``; the
same numpy inputs go through both on the CPU in float32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu.foundation_models import clip as jclip
from semanticlens_tpu.models import layers as jlayers
from semanticlens_tpu.models.resnet import ResNet as JResNet
from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch.foundation_models import clip as tclip
from semanticlens_tpu_torch.models import layers as tlayers
from semanticlens_tpu_torch.models.resnet import ResNet as TResNet

torch.set_num_threads(2)

TINY_J = jclip.CLIPConfig(
    embed_dim=16,
    vision=jclip.VisionCfg(kind="vit", image_size=16, patch_size=8, width=32, layers=2, heads=2),
    text=jclip.TextCfg(context_length=12, vocab_size=50, width=32, heads=2, layers=2),
)
TINY_T = tclip.CLIPConfig(
    embed_dim=16,
    vision=tclip.VisionCfg(image_size=16, patch_size=8, width=32, layers=2, heads=2),
    text=tclip.TextCfg(context_length=12, vocab_size=50, width=32, heads=2, layers=2),
)


def _jax_params(np_params):
    return {k: jnp.asarray(v) for k, v in np_params.items()}


@pytest.fixture(scope="module")
def resnet18_pair():
    tmodel = TResNet(depth=18, num_classes=10, dtype=torch.float32, device="cpu")
    np_params = tmodel.init_jax_layout(seed=0)
    # Non-trivial BN tensors (every 1-D tensor but fc.bias) so the BN fold is exercised.
    rng = np.random.default_rng(1)
    for name, arr in np_params.items():
        if arr.ndim == 1 and name != "fc.bias":
            if name.endswith(("weight", "running_var")):
                np_params[name] = rng.uniform(0.5, 1.5, size=arr.shape).astype(np.float32)
            else:
                np_params[name] = rng.normal(scale=0.1, size=arr.shape).astype(np.float32)
    jmodel = JResNet(depth=18, num_classes=10, dtype=jnp.float32)
    return jmodel, _jax_params(np_params), tmodel, tmodel.load_jax_params(np_params)


def test_resnet18_logits_and_every_tap_match_jax(resnet18_pair):
    """float32 at 32×32: atol 1e-4 + rtol 1e-4 (conv sums in another order)."""
    jmodel, jparams, tmodel, tparams = resnet18_pair
    assert tmodel.module_names == jmodel.module_names
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    names = tuple(jmodel.module_names)
    jlogits, jtaps = jmodel.apply(jparams, jnp.asarray(x), names)
    tlogits, ttaps = tmodel.apply(tparams, torch.from_numpy(x), names)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    assert set(ttaps) == set(jtaps)
    for name in names:
        ref = np.asarray(jtaps[name])
        ours = ttaps[name].numpy()
        assert ours.shape == ref.shape, name  # conv taps NHWC, as in the JAX package
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4, err_msg=name)


def test_resnet_repr_matches_jax_for_cache_names():
    assert repr(TResNet(depth=50, device="cpu")) == repr(JResNet(depth=50))


def test_resnet_rejects_wrong_shapes():
    tmodel = TResNet(depth=18, device="cpu")
    bad = convert.zoo_params_from_jax(tmodel.init_jax_layout(0), tmodel._param_specs())
    bad["fc.weight"] = bad["fc.weight"].T
    with pytest.raises(ValueError):
        tmodel.load_torch_state_dict(bad)


def test_layers_max_pool_ceil_mode_and_mha_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 9, 4)).astype(np.float32)
    ref = np.asarray(jlayers.max_pool(jnp.asarray(x), window=3, stride=2, padding=1, ceil_mode=True))
    ours = tlayers.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), window=3, stride=2, padding=1,
                            ceil_mode=True).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(ours, ref)

    d, t = 8, 5
    jp = {
        "a.in_proj_weight": rng.normal(size=(d, 3 * d)).astype(np.float32) * 0.3,
        "a.in_proj_bias": rng.normal(size=(3 * d,)).astype(np.float32) * 0.1,
        "a.out_proj.weight": rng.normal(size=(d, d)).astype(np.float32) * 0.3,
        "a.out_proj.bias": rng.normal(size=(d,)).astype(np.float32) * 0.1,
    }
    tp = convert.clip_params_from_jax(jp)
    h = rng.normal(size=(2, t, d)).astype(np.float32)
    mask = np.triu(np.full((t, t), -np.inf, np.float32), k=1)
    ref = np.asarray(jlayers.multi_head_attention(jnp.asarray(h), _jax_params(jp), "a", 2,
                                                  mask=jnp.asarray(mask)))
    ours = tlayers.multi_head_attention(torch.from_numpy(h), tp, "a", 2, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny_clip_params():
    np_params = tclip.init_clip_params_jax_layout(0, TINY_T)
    tparams = tclip.OpenClip("ViT-B-32", cfg=TINY_T, jax_params=np_params, dtype=torch.float32, device="cpu").params
    return _jax_params(np_params), tparams


def test_tiny_clip_image_tower_matches_jax(tiny_clip_params):
    """float32: atol 2e-4 (the JAX package's own torch-twin tolerance)."""
    jparams, tparams = tiny_clip_params
    imgs = np.random.default_rng(4).normal(size=(3, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(jclip.vit_encode_image(jparams, TINY_J, jnp.asarray(imgs)))
    ours = tclip.vit_encode_image(tparams, TINY_T, torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4)


def test_tiny_clip_text_tower_matches_jax(tiny_clip_params):
    jparams, tparams = tiny_clip_params
    tokens = np.zeros((2, 12), np.int32)
    tokens[0, :4] = [48, 5, 7, 49]
    tokens[1, :6] = [48, 9, 2, 11, 3, 49]
    ref = np.asarray(jclip.clip_encode_text(jparams, TINY_J, jnp.asarray(tokens)))
    ours = tclip.clip_encode_text(tparams, TINY_T, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4)


def test_tower_taps_match_jax(tiny_clip_params):
    """``tap=`` on the ViT and text towers: the same names (each block's ``.attn`` and ``.mlp`` branch and
    output), values within the towers' atol 2e-4; a tap that rewrites a value (the block-0 MLP branch
    zeroed) changes both packages' embeddings alike."""
    jparams, tparams = tiny_clip_params
    imgs = np.random.default_rng(4).normal(size=(3, 16, 16, 3)).astype(np.float32)
    tokens = np.zeros((2, 12), np.int32)
    tokens[0, :4] = [48, 5, 7, 49]
    tokens[1, :6] = [48, 9, 2, 11, 3, 49]
    towers = ((jclip.vit_encode_image, tclip.vit_encode_image, imgs),
              (jclip.clip_encode_text, tclip.clip_encode_text, tokens))
    for jencode, tencode, inputs in towers:
        jtaps, ttaps = {}, {}
        jencode(jparams, TINY_J, jnp.asarray(inputs), tap=lambda n, v: jtaps.setdefault(n, v))
        tencode(tparams, TINY_T, torch.from_numpy(inputs), tap=lambda n, v: ttaps.setdefault(n, v))
        assert list(ttaps) == list(jtaps) and len(ttaps) == 3 * 2
        for name in jtaps:
            np.testing.assert_allclose(ttaps[name].numpy(), np.asarray(jtaps[name]), atol=2e-4, err_msg=name)
        block = next(n for n in jtaps if n.endswith(".0.mlp"))
        ref = np.asarray(jencode(jparams, TINY_J, jnp.asarray(inputs),
                                 tap=lambda n, v: v * 0 if n == block else v))
        ours = tencode(tparams, TINY_T, torch.from_numpy(inputs), tap=lambda n, v: v * 0 if n == block else v)
        np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4)
        assert not np.allclose(ref, np.asarray(jencode(jparams, TINY_J, jnp.asarray(inputs))), atol=1e-3)


def test_clip_specs_and_presets_match_jax():
    for preset in tclip.CLIP_PRESETS:
        jspecs = jclip.clip_param_specs(jclip.CLIP_PRESETS[preset])
        assert tclip.clip_param_specs(tclip.CLIP_PRESETS[preset]) == jspecs
    assert tclip._resolve_preset("hf-hub:org/ViT-B-16-quickgelu") == "ViT-B-16"
    assert tclip._resolve_preset("ViT-B-16-plus-240") is None
    tiny = tclip.init_clip_params_jax_layout(0, TINY_T)
    for url in ("ViT-B-32", "hf-hub:laion/ViT-B-32-laion2b", "ViT-B-32-quickgelu"):
        jcfg = jclip.OpenClip(url, params={}).cfg
        tcfg = tclip.OpenClip(url, jax_params=tiny, cfg=TINY_T, device="cpu").cfg
        assert tcfg.quick_gelu == jcfg.quick_gelu, url
    with pytest.raises(ValueError):
        tclip.OpenClip("NotAModel-99", device="cpu")


def test_tokenizers_match_jax(tmp_path):
    """The port's tokenizer module is a copy: same ids on a miniature merges file."""
    from semanticlens_tpu.foundation_models import tokenizer as jtok
    from semanticlens_tpu_torch.foundation_models import tokenizer as ttok

    merges = ["#version: 0.2", "h e", "he l", "hel l", "hell o</w>", "l o</w>", "d o", "do g</w>"]
    (tmp_path / "bpe.txt").write_text("\n".join(merges) + "\n")
    texts = ["hello dog", "Hello, WORLD!! ² ½", "  a  photo of &amp; a dog  ", "x" * 40, ""]
    j, t = jtok.ClipBpeTokenizer(tmp_path / "bpe.txt", 8), ttok.ClipBpeTokenizer(tmp_path / "bpe.txt", 8)
    np.testing.assert_array_equal(t(texts), j(texts))
    np.testing.assert_array_equal(ttok.HashTokenizer(50, 6)(texts), jtok.HashTokenizer(50, 6)(texts))


def test_openclip_takes_a_torch_state_dict(tiny_clip_params):
    """``params=`` (open_clip names, torch layout) and ``jax_params=`` give the same tower."""
    jparams, tparams = tiny_clip_params
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    a = tclip.OpenClip("ViT-B-32", jax_params=np_params, dtype=torch.float32, device="cpu", cfg=TINY_T)
    b = tclip.OpenClip("ViT-B-32", params=convert.clip_params_from_jax(np_params), dtype=torch.float32,
                       device="cpu", cfg=TINY_T)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 16, 16, 3)).astype(np.float32))
    assert torch.equal(a.encode_image(x), b.encode_image(x))


def test_openclip_preprocess_and_encoders_match_jax(tiny_clip_params):
    """Through the user-facing class (tiny tower, float32, CPU)."""
    from semanticlens_tpu.foundation_models.tokenizer import HashTokenizer as JHash

    jparams, _ = tiny_clip_params
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    jfm = jclip.OpenClip("ViT-B-32", params=jparams, dtype=jnp.float32)
    jfm.cfg, jfm.tokenizer = TINY_J, JHash(50, 12)
    tfm = tclip.OpenClip("ViT-B-32", jax_params=np_params, dtype=torch.float32, device="cpu", cfg=TINY_T)
    assert tfm.name == jfm.name and repr(tfm) == repr(jfm)
    imgs = np.random.default_rng(5).integers(0, 256, size=(2, 20, 24, 3), dtype=np.uint8)
    ref = np.asarray(jfm.encode_image(jfm.preprocess(imgs)))
    ours = tfm.encode_image(tfm.preprocess(imgs)).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4)
    texts = ["a photo of a dog", "cat"]
    np.testing.assert_array_equal(tfm.tokenize(texts).numpy(), np.asarray(jfm.tokenize(texts)))
    np.testing.assert_allclose(tfm.encode_text(tfm.tokenize(texts)).numpy(),
                               np.asarray(jfm.encode_text(jfm.tokenize(texts))), atol=2e-4)
