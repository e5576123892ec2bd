"""The port's asset discovery, tokenizer auto-discovery and ``create`` against the JAX package.

``assets.py`` is a copy: on the same directory trees (``$SEMANTICLENS_ASSETS``,
a checkpoint's folder, nested folders, HF-hub snapshot folders with the
name filter, a file that only looks like a SentencePiece model) both
packages find the same files in the same order with the same source tags.
``OpenClip`` without ``bpe_path`` finds a BPE file next to its checkpoint
and gives the JAX package's token ids; ``SigLipV2`` finds a SentencePiece
model; ``create`` routes every name to the family and version the JAX
``create`` does, dropping keyword arguments a family does not take.
"""

import gzip

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu import foundation_models as jfms
from semanticlens_tpu.foundation_models import assets as jassets
from semanticlens_tpu.foundation_models import clip as jclip
from semanticlens_tpu_torch import foundation_models as tfms
from semanticlens_tpu_torch.foundation_models import assets as tassets
from semanticlens_tpu_torch.foundation_models import clip as tclip
from semanticlens_tpu_torch.foundation_models import mobileclip as tmc
from semanticlens_tpu_torch.foundation_models import siglip as tsig
from semanticlens_tpu_torch.foundation_models.sentencepiece import (
    UNKNOWN,
    SigLipTokenizer,
    SpModel,
    serialize_model,
)
from semanticlens_tpu_torch.foundation_models.tokenizer import ClipBpeTokenizer, HashTokenizer

torch.set_num_threads(2)

MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"), ("w", "o"), ("wo", "r"), ("wor", "l"),
          ("worl", "d</w>")]
TEXT = dict(context_length=12, vocab_size=50, width=32, heads=2, layers=1)
VIT = dict(image_size=16, patch_size=8, width=32, layers=1, heads=2)
CLIP_T = tclip.CLIPConfig(embed_dim=16, vision=tclip.VisionCfg(**VIT), text=tclip.TextCfg(**TEXT))
SIGLIP_T = tsig.SigLIPConfig(embed_dim=32, image_size=16, patch_size=8, vision_width=32, vision_layers=1,
                             vision_heads=2, text_width=32, text_layers=1, text_heads=2, vocab_size=64,
                             context_length=8)
MOBILE_T = tmc.MobileCLIPConfig(embed_dim=16, image_size=32, depths=(1, 1, 1, 1), dims=(8, 16, 24, 32), attn_heads=2,
                                text=tmc.TextCfg(**TEXT))


def _write_gz(path):
    with gzip.open(path, "wt") as f:
        f.write("\n".join(["bpe_simple_vocab_16e6 (test subset)"] + [f"{a} {b}" for a, b in MERGES]))


def _write_merges(path):
    path.write_text("\n".join(["#version: 0.2"] + [f"{a} {b}" for a, b in MERGES]))


def _spm_bytes(n_extra=0):
    pieces = [("<unk>", 0.0, UNKNOWN), ("▁hi", -1.0, 1), ("</s>", 0.0, 3)]
    pieces += [(f"▁w{i}", -2.0, 1) for i in range(n_extra)]
    return serialize_model(SpModel(pieces=pieces, eos_id=2))


@pytest.fixture
def clean_env(monkeypatch, tmp_path):
    """No ambient assets: an empty HF home and no $SEMANTICLENS_ASSETS."""
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_empty"))
    monkeypatch.delenv("SEMANTICLENS_ASSETS", raising=False)
    return monkeypatch


def _both(patterns, **kwargs):
    got = list(tassets.iter_assets(patterns, **kwargs))
    assert got == list(jassets.iter_assets(patterns, **kwargs))
    return got


def test_discovery_order_and_sources_equal_jax(tmp_path, clean_env):
    """explicit → near → env (recursive) → HF snapshots (name-filtered), one hit per file."""
    explicit, weights, env, nested = (tmp_path / d for d in ("explicit", "weights", "env", "env/a/b"))
    for d in (explicit, weights, nested):
        d.mkdir(parents=True)
    _write_merges(explicit / "merges.txt")
    _write_merges(weights / "merges.txt")
    _write_gz(nested / "bpe_simple_vocab_16e6.txt.gz")
    hub = tmp_path / "hf" / "hub"
    for model, name in (("models--openai--clip-vit-base", "merges.txt"), ("models--gpt2", "merges.txt"),
                        ("models--timm--ViT-B-16-SigLIP2", "spiece.model")):
        snap = hub / model / "snapshots" / "abc123"
        snap.mkdir(parents=True)
        (snap / name).write_bytes(_spm_bytes()) if name.endswith(".model") else _write_merges(snap / name)
    clean_env.setenv("SEMANTICLENS_ASSETS", str(env))
    clean_env.setenv("HF_HOME", str(tmp_path / "hf"))

    hits = _both(tassets.CLIP_BPE_PATTERNS, near=weights / "model.safetensors", extra_dirs=[explicit],
                 hf_name_filter="clip")
    assert [(p.relative_to(tmp_path).as_posix(), s) for p, s in hits] == [
        ("explicit/merges.txt", "explicit"), ("weights/merges.txt", "near"),
        ("env/a/b/bpe_simple_vocab_16e6.txt.gz", "env"),
        ("hf/hub/models--openai--clip-vit-base/snapshots/abc123/merges.txt", "hf")]
    unfiltered = _both(("merges.txt",))  # without a name filter the gpt2 snapshot's file comes too
    assert [p.parent.parent.parent.name for p, _ in unfiltered] == ["models--gpt2", "models--openai--clip-vit-base"]
    for kwargs in ({}, {"near": weights / "model.safetensors"}, {"near": weights}):
        assert tassets.find_clip_bpe(**kwargs) == jassets.find_clip_bpe(**kwargs)
    assert tassets.find_clip_bpe(near=weights / "x.safetensors") == weights / "merges.txt"
    assert tassets.find_asset(("*.gz",)) == jassets.find_asset(("*.gz",)) == nested / "bpe_simple_vocab_16e6.txt.gz"
    assert tassets.find_sentencepiece() == jassets.find_sentencepiece() is not None


def test_find_sentencepiece_validates_content_as_jax(tmp_path, clean_env):
    clean_env.setenv("SEMANTICLENS_ASSETS", str(tmp_path))
    (tmp_path / "fake.model").write_bytes(b"PK\x03\x04 not sentencepiece")
    assert tassets.find_sentencepiece() is None and jassets.find_sentencepiece() is None
    (tmp_path / "real.model").write_bytes(_spm_bytes())
    assert tassets.find_sentencepiece() == jassets.find_sentencepiece() == tmp_path / "real.model"
    # an explicitly configured root is used even with the wrong piece count; an HF hit is skipped
    assert tassets.find_sentencepiece(expected_vocab=10) == tmp_path / "real.model"
    clean_env.delenv("SEMANTICLENS_ASSETS")
    snap = tmp_path / "hf" / "hub" / "models--timm--siglip" / "snapshots" / "s"
    snap.mkdir(parents=True)
    (snap / "spiece.model").write_bytes(_spm_bytes())
    clean_env.setenv("HF_HOME", str(tmp_path / "hf"))
    for vocab, want in ((3, snap / "spiece.model"), (10, None)):
        assert tassets.find_sentencepiece(expected_vocab=vocab) == jassets.find_sentencepiece(expected_vocab=vocab) \
            == want


def test_openclip_finds_bpe_next_to_its_checkpoint_as_jax(tmp_path, clean_env):
    """Without ``bpe_path`` the port's OpenClip looks next to its checkpoint (JAX ``clip.py:523-525``): the
    same BPE file, the same token ids as the JAX OpenClip given the same checkpoint path."""
    from semanticlens_tpu_torch.utils import safetensors_io

    weights = tmp_path / "weights"
    weights.mkdir()
    params = tclip.init_clip_params_jax_layout(0, CLIP_T)
    ckpt = weights / "model.safetensors"
    safetensors_io.save_file(tfms.OpenClip("ViT-B-32", jax_params=params, dtype=torch.float32, device="cpu",
                                           cfg=CLIP_T).params, ckpt)
    assert isinstance(tfms.OpenClip("ViT-B-32", checkpoint=ckpt, device="cpu", cfg=CLIP_T).tokenizer, HashTokenizer)
    _write_merges(weights / "merges.txt")
    tfm = tfms.OpenClip("ViT-B-32", checkpoint=ckpt, dtype=torch.float32, device="cpu", cfg=CLIP_T)
    jfm = jclip.OpenClip("ViT-B-32", params={k: jnp.asarray(v) for k, v in params.items()}, checkpoint=str(ckpt),
                         dtype=jnp.float32)
    assert isinstance(tfm.tokenizer, ClipBpeTokenizer)
    prompts = ["hello world", "a photo of a hello"]
    np.testing.assert_array_equal(tfm.tokenize(prompts, 16).numpy(), np.asarray(jfm.tokenize(prompts, 16)))
    assert tfm.tokenizer.bpe("hello") == "hello</w>"
    # $SEMANTICLENS_ASSETS too, as the JAX test_assets.py case
    (weights / "merges.txt").unlink()
    env = tmp_path / "env"
    env.mkdir()
    _write_gz(env / "bpe_simple_vocab_16e6.txt.gz")
    clean_env.setenv("SEMANTICLENS_ASSETS", str(env))
    assert isinstance(tfms.OpenClip("ViT-B-32", checkpoint=ckpt, device="cpu", cfg=CLIP_T).tokenizer, ClipBpeTokenizer)
    assert isinstance(tfms.ClipMobile("s1", device="cpu", cfg=MOBILE_T).tokenizer, ClipBpeTokenizer)


def test_siglip_autodiscovers_sentencepiece(tmp_path, clean_env):
    from semanticlens_tpu.foundation_models.sentencepiece import SigLipTokenizer as JSigLipTokenizer

    assert isinstance(tsig.SigLipV2(device="cpu", cfg=SIGLIP_T).tokenizer, HashTokenizer)
    (tmp_path / "spiece.model").write_bytes(_spm_bytes(5))
    clean_env.setenv("SEMANTICLENS_ASSETS", str(tmp_path))
    fm = tsig.SigLipV2(device="cpu", dtype=torch.float32, cfg=SIGLIP_T)
    assert isinstance(fm.tokenizer, SigLipTokenizer)
    tokens = fm.tokenize(["hi", "hi w3 hi"])
    assert tokens.shape == (2, 8) and tokens.dtype == torch.long
    np.testing.assert_array_equal(tokens.numpy(), JSigLipTokenizer(tmp_path / "spiece.model", 8)(["hi", "hi w3 hi"]))
    assert fm.encode_text(tokens).shape == (2, 32)
    # next to a checkpoint file, and an explicit path or object first
    clean_env.delenv("SEMANTICLENS_ASSETS")
    weights = tmp_path / "weights"
    weights.mkdir()
    (weights / "tokenizer.model").write_bytes(_spm_bytes())
    ckpt = weights / "w.npz"
    np.savez(ckpt, **{k: v.numpy() for k, v in fm.params.items()})
    assert tsig.SigLipV2(checkpoint=ckpt, device="cpu", cfg=SIGLIP_T).tokenizer.vocab_size == 3
    assert tsig.SigLipV2(tokenizer_path=tmp_path / "spiece.model", device="cpu", cfg=SIGLIP_T).tokenizer.vocab_size == 8
    own = HashTokenizer(64, 8)
    assert tsig.SigLipV2(tokenizer=own, tokenizer_path=tmp_path / "spiece.model", device="cpu",
                         cfg=SIGLIP_T).tokenizer is own


ROUTES = ["ViT-B-32", "RN50", "hf-hub:laion/ViT-B-32-laion2b", "siglip", "siglip2", "ViT-B-16-SigLIP2",
          "mobileclip", "mobileclip-s1", "MobileCLIP-S2"]


@pytest.mark.parametrize("name", ROUTES)
def test_create_routes_as_jax(name, monkeypatch, clean_env):
    """Each name goes to the family (and MobileCLIP version) the JAX ``create`` picks; the JAX classes are
    replaced by recorders so no full-size JAX tower is built."""
    routed = {}

    def recorder(family):
        def make(*args, **kwargs):
            routed.update(family=family, args=args)
        return make

    for family in ("OpenClip", "SigLipV2", "ClipMobile"):
        monkeypatch.setattr(jfms, family, recorder(family))
    jfms.create(name, dtype=jnp.float32)
    kwargs = dict(device="cpu", dtype=torch.float32, seed=0, bpe_path=None, tokenizer_path=None, mesh=None,
                  quick_gelu=None)
    cfg = {"SigLipV2": SIGLIP_T, "ClipMobile": MOBILE_T}.get(routed["family"], CLIP_T)
    fm = tfms.create(name, cfg=cfg, **kwargs)  # each family drops the keyword arguments it does not take
    assert type(fm).__name__ == routed["family"]
    if routed["family"] == "ClipMobile":
        version = "s2" if name.lower().endswith("s2") else "s1"
        assert fm.url == tmc.ClipMobile.URLs[version]
    if routed["family"] == "OpenClip":
        assert fm.url == routed["args"][0] == name
    assert fm.device == torch.device("cpu")
