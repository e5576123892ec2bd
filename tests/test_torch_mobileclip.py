"""Port parity of MobileCLIP (``foundation_models/mobileclip.py``) against the JAX package.

A cut-down tower (depths (1, 1, 1, 1), dims (8, 16, 32, 64), 64×64 images,
2 attention heads, a 1-layer text tower) with random weights drawn in the
JAX layout and carried across by ``convert.mobileclip_params_from_jax``: the
image tower (NCHW, depthwise OIHW kernels, attention over the row-major
(h, w) tokens) and the text tower (exact GELU) must give the JAX package's
embeddings within atol 1e-5 in float32 (embeddings of norm ≈ 1–10). The
loader takes the three checkpoint forms — the own layout, deployed
``reparam_conv`` and raw train-form MobileOne/RepMixer branch sets and
conv+BN pairs — and gives exactly the tensors of the JAX loader, relaid out;
the folded towers (embeddings of norm ≈ 50) agree within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu.foundation_models import mobileclip as jmc
from semanticlens_tpu.foundation_models.clip import TextCfg as JTextCfg
from semanticlens_tpu.foundation_models.reparam import (fuse_conv_bn, fuse_mobileone_block, fuse_repmixer,
                                                        identity_kernel)
from semanticlens_tpu.foundation_models.tokenizer import HashTokenizer as JHash
from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch.foundation_models import mobileclip as tmc

torch.set_num_threads(2)

TINY_KW = dict(embed_dim=16, image_size=64, depths=(1, 1, 1, 1), dims=(8, 16, 32, 64), attn_heads=2)
TEXT = dict(context_length=10, vocab_size=50, width=16, heads=2, layers=1)
TINY_J = jmc.MobileCLIPConfig(**TINY_KW, text=JTextCfg(**TEXT))
TINY_T = tmc.MobileCLIPConfig(**TINY_KW, text=tmc.TextCfg(**TEXT))
ATOL = 1e-5
BN = ("weight", "bias", "running_mean", "running_var")


def _np_params(seed=0):
    params = tmc.init_mobileclip_params_jax_layout(seed, TINY_T)
    rng = np.random.default_rng(seed + 1)
    for name, value in params.items():
        if value.ndim == 1:  # non-trivial norms and biases
            params[name] = (value + rng.normal(0, 0.1, value.shape)).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def towers():
    params = _np_params()
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tfm = tmc.ClipMobile("s1", jax_params=params, dtype=torch.float32, device="cpu", cfg=TINY_T)
    return params, jparams, tfm


def test_specs_presets_and_init_match_jax():
    assert tmc.mobileclip_param_specs(TINY_T) == jmc.mobileclip_param_specs(TINY_J)
    assert set(tmc.MOBILECLIP_PRESETS) == set(jmc.MOBILECLIP_PRESETS) == {"MobileCLIP-S1", "MobileCLIP-S2"}
    for name, cfg in tmc.MOBILECLIP_PRESETS.items():
        assert tmc.mobileclip_param_specs(cfg) == jmc.mobileclip_param_specs(jmc.MOBILECLIP_PRESETS[name])


@pytest.mark.parametrize("batch", [1, 3])
def test_encode_image_matches_jax(towers, batch):
    _, jparams, tfm = towers
    x = np.random.default_rng(batch).random((batch, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jmc.mobileclip_encode_image(jparams, TINY_J, jnp.asarray(x)))
    got = tfm.encode_image(torch.from_numpy(x)).numpy()
    assert got.shape == (batch, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert tfm.params["visual.stage0.blocks.0.mixer.weight"].shape == (8, 1, 3, 3)  # depthwise OIHW


def test_clipmobile_api_matches_jax(towers, monkeypatch):
    """name, repr, embed_dim, the 0–1 preprocess at 256 → 64 here, tokens and the text tower (exact GELU)."""
    _, jparams, tfm = towers
    monkeypatch.setitem(jmc.MOBILECLIP_PRESETS, "MobileCLIP-S1", TINY_J)
    jfm = jmc.ClipMobile("s1", params=jparams, dtype=jnp.float32)
    jfm.tokenizer = JHash(50, 10)
    assert (tfm.name, repr(tfm), tfm.embed_dim, tfm.context_length) == \
        (jfm.name, repr(jfm), jfm.embed_dim, jfm.context_length) == \
        ("ClipMobile(MobileCLIP-S1)", "ClipMobile(url='MobileCLIP-S1')", 16, 10)
    images = np.random.default_rng(2).integers(0, 256, size=(2, 80, 72, 3), dtype=np.uint8)
    pre = tfm.preprocess(images)
    assert pre.shape == (2, 64, 64, 3) and float(pre.min()) >= -0.05 and float(pre.max()) <= 1.05
    np.testing.assert_allclose(pre.numpy(), np.asarray(jfm.preprocess(images)), atol=1e-5)
    np.testing.assert_allclose(tfm.encode_image(pre).numpy(), np.asarray(jfm.encode_image(jfm.preprocess(images))),
                               atol=ATOL)
    prompts = ["a dog", "a red car"]
    np.testing.assert_array_equal(tfm.tokenize(prompts).numpy(), np.asarray(jfm.tokenize(prompts)))
    np.testing.assert_allclose(tfm.encode_text(tfm.tokenize(prompts)).numpy(),
                               np.asarray(jfm.encode_text(jfm.tokenize(prompts))), atol=ATOL)


def test_bf16_tower_close_to_jax_float32(towers):
    params, jparams, _ = towers
    fm = tmc.ClipMobile("s2", jax_params=params, dtype=torch.bfloat16, device="cpu", cfg=TINY_T)
    assert fm.name == "ClipMobile(MobileCLIP-S2)"
    assert fm.params["visual.stage0.blocks.0.ffn.fc1.weight"].dtype == torch.bfloat16
    assert fm.params["visual.head.proj"].dtype == torch.float32
    x = np.random.default_rng(4).random((2, 64, 64, 3)).astype(np.float32)
    got = fm.encode_image(torch.from_numpy(x)).numpy()
    want = np.asarray(jmc.mobileclip_encode_image(jparams, TINY_J, jnp.asarray(x)))
    assert (np.sum(got * want, 1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))).min() > 0.995


# --------------------------------------------------------------------------- #
# The three checkpoint forms
# --------------------------------------------------------------------------- #
def _bn(rng, sd, prefix, c):
    sd[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, c)
    sd[f"{prefix}.bias"] = rng.normal(0, 0.1, c)
    sd[f"{prefix}.running_mean"] = rng.normal(0, 0.2, c)
    sd[f"{prefix}.running_var"] = rng.uniform(0.3, 1.3, c)


def _mobileone(rng, sd, prefix, cout, cin, k, n_conv, skip):
    for i in range(n_conv):
        sd[f"{prefix}.rbr_conv.{i}.conv.weight"] = rng.normal(0, 0.2, (cout, cin, k, k))
        _bn(rng, sd, f"{prefix}.rbr_conv.{i}.bn", cout)
    sd[f"{prefix}.rbr_scale.conv.weight"] = rng.normal(0, 0.2, (cout, cin, 1, 1))
    _bn(rng, sd, f"{prefix}.rbr_scale.bn", cout)
    if skip:
        _bn(rng, sd, f"{prefix}.rbr_skip", cout)


def _sites():
    """(site, form, out channels, in channels per group, k, groups) of every folded conv of the tiny tower."""
    d = TINY_T.dims
    sites = [("visual.stem.0", "mobileone", d[0] // 2, 3, 3, 1), ("visual.stem.1", "mobileone", d[0], d[0] // 2, 3, 1)]
    for s in range(4):
        if s > 0:
            sites += [(f"visual.stage{s}.downsample.dw", "mobileone+skip", d[s - 1], 1, 7, d[s - 1]),
                      (f"visual.stage{s}.downsample.pw", "conv_bn", d[s], d[s - 1], 1, 1)]
        if TINY_T.mixers[s] == "rep":
            sites.append((f"visual.stage{s}.blocks.0.mixer", "repmixer", d[s], 1, 3, d[s]))
        sites.append((f"visual.stage{s}.blocks.0.ffn.dw", "conv_bn", d[s], 1, 7, d[s]))
    return sites


def _forms(params, seed=5):
    """The own-layout, raw train-form and deployed (``reparam_conv``) state dicts of one tower.

    Train form: MobileOne branch sets (stems with two k×k branches; downsample depthwise convs with a BN
    skip), conv+BN pairs (pointwise downsample, ConvFFN depthwise) and RepMixer mixer/norm pairs.
    The deployed form folds them with the JAX package's reparam module; a RepMixer kernel carries the identity.
    """
    rng = np.random.default_rng(seed)
    own = {k: v.numpy() for k, v in convert.mobileclip_params_from_jax(params).items()}
    folded = {f"{site}.{suffix}" for site, *_ in _sites() for suffix in ("weight", "bias")}
    train = {k: v for k, v in own.items() if k not in folded}
    deployed = dict(train)
    for site, form, cout, cin, k, groups in _sites():
        if form.startswith("mobileone"):
            n_conv = 2 if site.startswith("visual.stem") else 1
            _mobileone(rng, train, site, cout, cin, k, n_conv, form.endswith("skip"))
            w, b = fuse_mobileone_block(train, site, channels=cout, groups=groups, k=k)
        elif form == "conv_bn":
            train[f"{site}.conv.weight"] = rng.normal(0, 0.2, (cout, cin, k, k))
            _bn(rng, train, f"{site}.bn", cout)
            w, b = fuse_conv_bn(train[f"{site}.conv.weight"], *(train[f"{site}.bn.{n}"] for n in BN))
        else:
            _mobileone(rng, train, f"{site}.mixer", cout, 1, k, 1, True)
            _bn(rng, train, f"{site}.norm.rbr_skip", cout)
            w, b = fuse_repmixer(train, site, channels=cout, k=k)
            w = w + identity_kernel(cout, cout, k)
        deployed[f"{site}.reparam_conv.weight"], deployed[f"{site}.reparam_conv.bias"] = w, b
    return {"own": own, "train": train, "deployed": deployed}


@pytest.mark.parametrize("form", ["own", "train", "deployed"])
def test_loader_equals_the_jax_loader(towers, form):
    params, _, _ = towers
    forms = _forms(params)
    sd = forms[form]
    assert form == "own" or "visual.stem.0.weight" not in sd
    jloaded = jmc.load_mobileclip_state_dict(TINY_J, sd)
    tloaded = tmc.load_mobileclip_state_dict(TINY_T, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    back = convert.mobileclip_params_from_jax({k: np.asarray(v) for k, v in jloaded.items()})
    assert set(tloaded) == set(back)
    for name in tloaded:
        assert torch.equal(tloaded[name], back[name]), name
    if form == "deployed":  # the same tower as the train form it was folded from
        from_train = tmc.load_mobileclip_state_dict(TINY_T, forms["train"])
        for name in tloaded:
            torch.testing.assert_close(tloaded[name], from_train[name], atol=1e-6, rtol=0)
    fm = tmc.ClipMobile("s1", params=sd, dtype=torch.float32, device="cpu", cfg=TINY_T)
    x = np.random.default_rng(6).random((2, 64, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(fm.encode_image(torch.from_numpy(x)).numpy(),
                               np.asarray(jmc.mobileclip_encode_image(jloaded, TINY_J, jnp.asarray(x))),
                               rtol=1e-5, atol=ATOL)


def test_loader_refusals(towers):
    params, _, _ = towers
    own = {k: v.numpy() for k, v in convert.mobileclip_params_from_jax(params).items()}
    with pytest.raises(KeyError, match="no reparameterizable branches|no source"):
        tmc.load_mobileclip_state_dict(TINY_T, {k: v for k, v in own.items() if "stem.0" not in k})
    bad = dict(own, **{"visual.head.proj": own["visual.head.proj"].T})
    with pytest.raises(ValueError, match="visual.head.proj"):
        tmc.load_mobileclip_state_dict(TINY_T, bad)


def test_checkpoint_file_and_refusals(tmp_path, towers):
    from semanticlens_tpu_torch.utils import safetensors_io

    params, _, tfm = towers
    sd = {k: v for k, v in convert.mobileclip_params_from_jax(params).items()}
    safetensors_io.save_file(sd, tmp_path / "w.safetensors")
    fm = tmc.ClipMobile("s1", checkpoint=tmp_path / "w.safetensors", dtype=torch.float32, device="cpu", cfg=TINY_T)
    for key, value in tfm.params.items():
        assert torch.equal(fm.params[key], value), key
    with pytest.raises(ValueError, match="Unknown MobileCLIP version"):
        tmc.ClipMobile("s9", device="cpu")
    for kwargs, error, match in (({"mesh": object()}, TypeError, "DeviceMesh"),
                                 ({"quantize": "int4"}, ValueError, "quantize")):
        with pytest.raises(error, match=match):
            tmc.ClipMobile("s1", device="cpu", cfg=TINY_T, **kwargs)
