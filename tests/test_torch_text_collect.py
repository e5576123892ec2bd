"""Port parity: the text Collect+Embed path (``collect/text_based.py``) against the JAX package's.

``TokenTextDataset.from_texts`` equals the JAX one (left and right pads,
tail truncation). The text concept DB: a tiny pad-aware GPT-2 and Llama
(weights shared through ``convert``) and the cut-down CLIP tower of
``test_torch_slice.py`` in float32 on the CPU, over a 22-text corpus at
batch 4 (a padded last batch): evidence ids equal, the DB and the
embedding table within 1e-5, the evidence texts and the written text
reports equal, and caches written by either package load in the other.
``TextSAEComponentVisualizer``: a dictionary trained by the port on a
token tap (l0 = k) audited by both packages with the same dictionary.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu.collect import TextActivationComponentVisualizer as JTCV
from semanticlens_tpu.collect import TextSAEComponentVisualizer as JTSAE
from semanticlens_tpu.collect import TokenTextDataset as JTDS
from semanticlens_tpu.foundation_models import clip as jclip
from semanticlens_tpu.foundation_models.tokenizer import HashTokenizer as JHash
from semanticlens_tpu.lens import Lens as JLens
from semanticlens_tpu_torch import convert, sae
from semanticlens_tpu_torch.collect import TextActivationComponentVisualizer as TTCV
from semanticlens_tpu_torch.collect import TextSAEComponentVisualizer as TTSAE
from semanticlens_tpu_torch.collect import TokenTextDataset as TTDS
from semanticlens_tpu_torch.foundation_models import clip as tclip
from semanticlens_tpu_torch.lens import Lens as TLens
from test_torch_lm_models import PAD, V, lm_pair
from test_torch_slice import TINY_J, TINY_T

torch.set_num_threads(2)

TOPICS = ["a sleeping cat", "a red car", "fresh bread", "a wooden chair", "heavy rain"]
TEXTS = [f"{TOPICS[i % 5]} appears in sentence {i}" for i in range(22)]
SEQ, SAMPLES, BATCH = 16, 3, 4


def tokenize(text):
    return [ord(c) % V for c in text]


@pytest.mark.parametrize("pad", ["left", "right"])
@pytest.mark.parametrize("seq_len", [8, 40])
def test_from_texts_equals_jax(pad, seq_len):
    got = TTDS.from_texts(TEXTS[:5] + [""], tokenize, seq_len, pad=pad, pad_id=PAD, name="c")
    want = JTDS.from_texts(TEXTS[:5] + [""], tokenize, seq_len, pad=pad, pad_id=PAD, name="c")
    np.testing.assert_array_equal(got.images, want.images)
    assert got.images.dtype == want.images.dtype == np.int32
    assert (got.pad_id, got.pad, got.name, got.texts) == (want.pad_id, want.pad, want.name, want.texts)
    view = got.texts_view()
    assert view.name == "c" and len(view) == 6 and view[0] == TEXTS[0]
    np.testing.assert_array_equal(got[2], want[2])


def test_dataset_and_visualizer_refusals():
    with pytest.raises(ValueError, match="pad must be"):
        TTDS.from_texts(TEXTS, tokenize, 8, pad="middle")
    with pytest.raises(ValueError, match="tokens must be"):
        TTDS(np.zeros(4, np.int32), ["a"] * 4)
    with pytest.raises(ValueError, match="mismatch"):
        TTDS(np.zeros((4, 2), np.int32), ["a"] * 3)
    _, _, tmodel, tparams, _ = lm_pair("gpt2")
    tmodel.params, tmodel.name = tparams, "g"
    ds = TTDS.from_texts(TEXTS, tokenize, SEQ, pad_id=PAD, name="c")
    with pytest.raises(TypeError, match="DeviceMesh"):
        TTCV(tmodel, ds, ds.texts_view(), ["transformer.h.1.mlp.act"], 3, mesh=object())
    fm = tclip.OpenClip("ViT-B-32", jax_params=tclip.init_clip_params_jax_layout(1, TINY_T), dtype=torch.float32,
                        device="cpu", cfg=TINY_T)
    with pytest.raises(TypeError, match="raw strings"):
        TLens(fm).compute_concept_db(TTCV(tmodel, ds, ds, ["transformer.h.1.mlp.act"], 3), batch_size=BATCH)
    with pytest.raises(TypeError, match="raw strings"):
        TLens(fm).compute_concept_db(TTCV(tmodel, ds, list(range(len(ds))), ["transformer.h.1.mlp.act"], 3),
                                     batch_size=BATCH)


def _fms():
    np_clip = tclip.init_clip_params_jax_layout(1, TINY_T)
    jfm = jclip.OpenClip("ViT-B-32", params={k: jnp.asarray(v) for k, v in np_clip.items()}, dtype=jnp.float32)
    jfm.cfg, jfm.tokenizer = TINY_J, JHash(50, 12)
    tfm = tclip.OpenClip("ViT-B-32", jax_params=np_clip, dtype=torch.float32, device="cpu", cfg=TINY_T)
    return jfm, tfm


LAYERS = {"gpt2": ["transformer.h.1.mlp.act", "transformer.h.0.attn.heads"],
          "llama": ["model.layers.1.mlp.act_fn", "model.layers.1.self_attn.heads"]}


@pytest.fixture(scope="module", params=list(LAYERS))
def both(request, tmp_path_factory):
    family = request.param
    tmp = tmp_path_factory.mktemp(f"text-{family}")
    jmodel, jparams, tmodel, tparams, _ = lm_pair(family)
    jmodel.params, tmodel.params = jparams, tparams
    jmodel.name = tmodel.name = f"{family}-tiny"
    jfm, tfm = _fms()
    out = {"family": family, "tmp": tmp}
    for pkg, ds_cls, cv_cls, lens_cls, model, fm in (("jax", JTDS, JTCV, JLens, jmodel, jfm),
                                                     ("torch", TTDS, TTCV, TLens, tmodel, tfm)):
        ds = ds_cls.from_texts(TEXTS, tokenize, SEQ, pad_id=PAD, name="topics")
        cv = cv_cls(model=model, dataset_model=ds, dataset_fm=ds.texts_view(), layer_names=LAYERS[family],
                    num_samples=SAMPLES, cache_dir=str(tmp / pkg))
        db = {k: np.asarray(v) for k, v in lens_cls(fm).compute_concept_db(cv, batch_size=BATCH).items()}
        out[pkg] = {"cv": cv, "db": db, "table": np.asarray(cv.embedding_table),
                    "ids": {k: np.asarray(cv.get_max_reference(k)) for k in LAYERS[family]}}
    return out


def test_text_concept_db_matches_jax(both):
    j, t = both["jax"], both["torch"]
    np.testing.assert_allclose(t["table"], j["table"], atol=1e-5)
    for layer in LAYERS[both["family"]]:
        np.testing.assert_array_equal(t["ids"][layer], j["ids"][layer])
        assert t["db"][layer].shape == j["db"][layer].shape
        np.testing.assert_allclose(t["db"][layer], j["db"][layer], atol=1e-5)
        assert t["cv"].get_max_reference_texts(layer) == j["cv"].get_max_reference_texts(layer)


def test_text_reports_are_equal_and_written(both):
    for layer in LAYERS[both["family"]]:
        reports = [both[pkg]["cv"].visualize_components([0, 2], layer, n_samples=2) for pkg in ("jax", "torch")]
        assert reports[0] == reports[1] and reports[1].startswith(f"[{layer} #0]")
        path = both["torch"]["cv"].storage_dir / "plots" / f"{layer}-components.txt"
        assert path.read_text() == reports[1]
        assert both["torch"]["cv"].visualize_components([1], layer, save=False).startswith(f"[{layer} #1]")


def test_text_caches_load_in_the_other_package(both):
    family, tmp = both["family"], both["tmp"]
    for writer, reader, cv_cls, ds_cls in (("jax", "torch", TTCV, TTDS), ("torch", "jax", JTCV, JTDS)):
        own = both[reader]["cv"]
        ds = ds_cls.from_texts(TEXTS, tokenize, SEQ, pad_id=PAD, name="topics")
        cv = cv_cls(model=own.model, dataset_model=ds, dataset_fm=ds.texts_view(), layer_names=LAYERS[family],
                    num_samples=SAMPLES, cache_dir=str(tmp / writer), params=own.params)
        for layer in LAYERS[family]:
            np.testing.assert_array_equal(np.asarray(cv.get_max_reference(layer)), both[writer]["ids"][layer])


def test_text_sae_visualizer_trains_and_audits_like_jax(tmp_path):
    jmodel, jparams, tmodel, tparams, _ = lm_pair("llama")
    jmodel.params, tmodel.params = jparams, tparams
    jmodel.name = tmodel.name = "llama-tiny"
    layer = "model.layers.1.mlp.act_fn"
    ds = TTDS.from_texts(TEXTS[:16], tokenize, SEQ, pad_id=PAD, name="topics")
    cfg = sae.SAEConfig(d_in=256, n_latents=64, k=4, batch_rows=32, lr=1e-3)
    record = []
    run_steps = sae._run_steps

    def recording(*args, **kwargs):
        run = run_steps(*args, **kwargs)

        def wrapped(*a):
            out = run(*a)
            record.append(out[3])
            return out

        return wrapped

    sae._run_steps = recording
    try:
        params = TTSAE.train(tmodel, ds, layer, cfg, batch_size=4)
    finally:
        sae._run_steps = run_steps
    assert int(params["k"]) == 4 and record
    assert all(float(l0) == 4.0 for m in record for l0 in m["l0"].reshape(-1))
    jfm, tfm = _fms()
    jds = JTDS.from_texts(TEXTS[:16], tokenize, SEQ, pad_id=PAD, name="topics")
    tcv = TTSAE(tmodel, ds, ds.texts_view(), layer, params, SAMPLES, cache_dir=str(tmp_path / "t"))
    jcv = JTSAE(jmodel, jds, jds.texts_view(), layer, {k: jnp.asarray(v) for k, v in
                                                       convert.sae_params_to_jax(params).items()},
                SAMPLES, cache_dir=str(tmp_path / "j"))
    tdb = TLens(tfm).compute_concept_db(tcv, batch_size=BATCH)[tcv.layer_names[0]]
    jdb = JLens(jfm).compute_concept_db(jcv, batch_size=BATCH)[jcv.layer_names[0]]
    assert tcv.layer_names == jcv.layer_names == [f"{layer}.sae"]
    np.testing.assert_array_equal(tcv.get_max_reference(tcv.layer_names[0]),
                                  np.asarray(jcv.get_max_reference(jcv.layer_names[0])))
    np.testing.assert_allclose(np.asarray(tdb), np.asarray(jdb), atol=1e-5)
    assert tcv.get_max_reference_texts(tcv.layer_names[0]) == jcv.get_max_reference_texts(jcv.layer_names[0])
