"""Port parity of concept-search serving: ``semanticlens_tpu_torch.serve`` against ``semanticlens_tpu.serve``.

Both services run over the same aggregated DB with a cut-down CLIP whose
numpy weights both packages share (the port's through ``convert.py``), on
the CPU. Served ids must be equal and scores within 1e-5 (cosines; the JSON
rounds them to 6 decimals). HTTP runs on loopback, as ``tests/test_serve.py``
does for the JAX service.
"""

import json
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu import serve as jserve
from semanticlens_tpu.foundation_models import clip as jclip
from semanticlens_tpu.foundation_models.tokenizer import HashTokenizer as JHash
from semanticlens_tpu_torch import lens as tlens
from semanticlens_tpu_torch import serve as tserve
from semanticlens_tpu_torch.foundation_models import clip as tclip

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
TEMPLATES = ["a photo of a {}", "{} in the wild"]
WORDS = ["dog", "cat", "red car", "tree", "sky", "boat"]


@pytest.fixture(scope="module")
def fms():
    np_clip = tclip.init_clip_params_jax_layout(2, TINY_T)
    jfm = jclip.OpenClip("ViT-B-32", params={k: jnp.asarray(v) for k, v in np_clip.items()}, dtype=jnp.float32)
    jfm.cfg, jfm.tokenizer = TINY_J, JHash(50, 12)
    tfm = tclip.OpenClip("ViT-B-32", jax_params=np_clip, dtype=torch.float32, device="cpu", cfg=TINY_T)
    return jfm, tfm


@pytest.fixture(scope="module")
def db():
    rng = np.random.default_rng(0)
    return {"layer3": rng.normal(size=(30, 16)).astype(np.float32),
            "layer4": rng.normal(size=(70, 16)).astype(np.float32)}


@pytest.fixture(scope="module", params=[None, TEMPLATES], ids=["plain", "templates"])
def services(request, fms, db):
    jfm, tfm = fms
    return (jserve.SearchService(jfm, db, templates=request.param),
            tserve.SearchService(tfm, db, templates=request.param))


def _assert_same_results(t, j):
    assert t.keys() == j.keys()
    for layer in j:
        assert t[layer]["ids"] == j[layer]["ids"]
        np.testing.assert_allclose(t[layer]["scores"], j[layer]["scores"], atol=1e-5)


@pytest.mark.parametrize("k", [1, 5, 32, 33, 64, 100])
def test_text_search_matches_jax(services, k):
    """k ≤ 32 goes through the JAX service's fused program, k > 32 through its streaming
    search; the port has one path. k past a layer's size returns the whole layer."""
    jsvc, tsvc = services
    for query in ("dog", "red car"):
        t = tsvc.text_search(query, k=k)
        _assert_same_results(t, jsvc.text_search(query, k=k))
        assert len(t["layer3"]["ids"]) == min(k, 30) and len(t["layer4"]["ids"]) == min(k, 70)


@pytest.mark.parametrize("k", [3, 40])
def test_image_search_matches_jax(services, k):
    image = np.random.default_rng(1).integers(0, 256, size=(20, 24, 3), dtype=np.uint8)
    jsvc, tsvc = services
    _assert_same_results(tsvc.image_search(image, k=k), jsvc.image_search(image, k=k))


def test_served_text_search_equals_offline_probing(services, fms, db):
    _, tsvc = services
    _, tfm = fms
    probe = tlens.text_probing(tfm, "dog", db, templates=tsvc.templates)
    out = tsvc.text_search("dog", k=10)
    for layer, scores in probe.items():
        order = torch.sort(torch.from_numpy(scores[0]), descending=True, stable=True).indices[:10]
        assert out[layer]["ids"] == order.tolist()
        np.testing.assert_allclose(out[layer]["scores"], scores[0][order.numpy()], atol=1e-6)


@pytest.mark.parametrize("top_m, max_components", [(1, 64), (3, 10), (6, 100)])
def test_label_matches_jax(services, top_m, max_components):
    jsvc, tsvc = services
    t = tsvc.label(WORDS, top_m=top_m, max_components=max_components)
    j = jsvc.label(WORDS, top_m=top_m, max_components=max_components)
    for layer in j:
        assert [r["component"] for r in t[layer]] == [r["component"] for r in j[layer]]
        assert [r["words"] for r in t[layer]] == [r["words"] for r in j[layer]]
        np.testing.assert_allclose([r["scores"] for r in t[layer]], [r["scores"] for r in j[layer]], atol=1e-5)


def test_vocab_cache_hits_and_evicts_like_jax(fms, db):
    jfm, tfm = fms
    calls = {"n": 0}

    class Counting(tclip.OpenClip):
        def encode_text(self, tokens):
            calls["n"] += 1
            return super().encode_text(tokens)

    counting = Counting("ViT-B-32", jax_params=tclip.init_clip_params_jax_layout(2, TINY_T), dtype=torch.float32,
                        device="cpu", cfg=TINY_T)
    svc = tserve.SearchService(counting, db, warmup=False)
    first = svc.label(WORDS, top_m=2)
    n_cold = calls["n"]
    assert svc.label(WORDS, top_m=2) == first and calls["n"] == n_cold  # cached: no text-tower pass
    assert svc.VOCAB_CACHE_ENTRIES == jserve.SearchService.VOCAB_CACHE_ENTRIES == 8
    for i in range(svc.VOCAB_CACHE_ENTRIES):
        svc.label([f"w{i}", "dog"], top_m=1)
    assert len(svc._vocab_cache) == svc.VOCAB_CACHE_ENTRIES
    assert (tuple(WORDS), None) not in svc._vocab_cache  # the oldest went first
    svc.label(WORDS, top_m=2)
    assert calls["n"] > n_cold


def test_device_work_runs_on_one_service_thread(fms, db):
    """Requests from many threads run the towers and K1 on the service's one device thread
    (PyTorch's per-thread state, e.g. cuDNN attention plans, stays warm there), under
    inference mode."""
    seen = []

    class Recording(tclip.OpenClip):
        def encode_text(self, tokens):
            seen.append((threading.current_thread().name, torch.is_inference_mode_enabled()))
            return super().encode_text(tokens)

    fm = Recording("ViT-B-32", jax_params=tclip.init_clip_params_jax_layout(2, TINY_T), dtype=torch.float32,
                   device="cpu", cfg=TINY_T)
    svc = tserve.SearchService(fm, db, templates=TEMPLATES)
    threads = [threading.Thread(target=svc.text_search, args=(w,)) for w in WORDS]
    threads.append(threading.Thread(target=svc.label, args=(WORDS,)))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    request_calls = seen[1:]  # the first is the empty-template embedding at construction
    assert len(request_calls) >= len(WORDS) + 1
    assert {name for name, _ in request_calls} == {svc._device_thread._thread_name_prefix + "_0"}
    assert all(inference for _, inference in request_calls)
    svc.close()


def test_service_construction(fms):
    _, tfm = fms
    with pytest.raises(ValueError, match="at least one layer"):
        tserve.SearchService(tfm, {})
    assert tserve.MAX_BODY_BYTES == jserve.MAX_BODY_BYTES


def test_service_needs_the_fm_device(db):
    """An FM that names no device is refused, not served from the CPU."""

    class NoDevice:
        def tokenize(self, texts):
            raise AssertionError("never reached")

    with pytest.raises(AttributeError, match="device"):
        tserve.SearchService(NoDevice(), db, warmup=False)


# --------------------------------------------------------------------------- #
# HTTP
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def http(fms, db):
    _, tfm = fms
    service = tserve.SearchService(tfm, db, templates=TEMPLATES)
    server, thread = tserve.serve(service, port=0, background=True)
    yield service, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def _status(request):
    try:
        with urllib.request.urlopen(request, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_http_endpoints(http):
    service, base = http
    assert _get(f"{base}/healthz") == (200, {"ok": True, "layers": ["layer3", "layer4"]})
    status, out = _get(f"{base}/text_search?q=red%20car&k=4")
    assert status == 200 and out["query"] == "red car"
    assert out["results"] == service.text_search("red car", k=4)
    status, out = _get(f"{base}/label?words=dog,cat,sky&top_m=2&max_components=12")
    assert status == 200 and out["truncated"] is True and out["max_components"] == 12
    assert out["results"] == service.label(["dog", "cat", "sky"], 2, 12)
    assert len(out["results"]["layer4"]) == 12


def test_http_errors(http):
    _, base = http
    for path in ("/text_search", "/text_search?q=dog&k=0", "/text_search?q=dog&k=five",
                 "/label?words=", "/label?words=dog&top_m=-1"):
        assert _status(f"{base}{path}")[0] == 400, path
    assert _status(f"{base}/nope")[0] == 404

    def post(path, body, headers=None):
        return _status(urllib.request.Request(f"{base}{path}", data=body, headers=headers or {}, method="POST"))

    assert post("/other", b"x")[0] == 404
    assert post("/image_search", b"")[0] == 400
    status, out = post("/image_search", b"x", {"Content-Length": str(tserve.MAX_BODY_BYTES + 1)})
    assert status == 413 and "exceeds cap" in out["error"]
    status, out = post("/image_search?k=3", np.zeros(64, np.uint8).tobytes())  # not a JPEG
    assert status == 400 and "request body" in out["error"]
    status, out = post("/image_search?k=0", _jpeg_bytes())
    assert status == 400 and "k must be >= 1" in out["error"]


def test_http_image_search_server_fault_is_500(http, monkeypatch):
    """Only a body the decoder refuses (and a bad ``k``) is the client's fault: a ``ValueError`` raised
    past the decoder, as K1 raises for operands it refuses, answers 500."""
    service, base = http

    def refused(image, k):
        raise ValueError("operands refused")

    monkeypatch.setattr(service, "_image_search", refused)
    request = urllib.request.Request(f"{base}/image_search?k=3", data=_jpeg_bytes(), method="POST")
    status, out = _status(request)
    assert status == 500 and "operands refused" in out["error"]


def _jpeg_bytes(seed=4, size=(37, 29)):
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0 : size[1], 0 : size[0]]
    img = np.stack([x * 6 % 256, y * 8 % 256, (x + y) * 3 % 256], -1) + rng.integers(0, 30, (size[1], size[0], 3))
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, "JPEG", quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("k", [3, 40])
def test_http_image_search_matches_jax_server(http, fms, k):
    """POST /image_search with JPEG bytes: the port decodes at full resolution (libjpeg here, nvJPEG on
    the card) as the JAX server does with PIL; ids equal, scores within 1e-5."""
    jfm, _ = fms
    _, base = http
    jservice = jserve.SearchService(jfm, http[0].banks, templates=TEMPLATES)
    jserver, jthread = jserve.serve(jservice, port=0, background=True)
    try:
        data = _jpeg_bytes()
        results = {}
        for name, url in (("torch", base), ("jax", f"http://127.0.0.1:{jserver.server_address[1]}")):
            request = urllib.request.Request(f"{url}/image_search?k={k}", data=data, method="POST")
            status, out = _status(request)
            assert status == 200, (name, out)
            results[name] = out["results"]
        _assert_same_results(results["torch"], results["jax"])
        assert len(results["torch"]["layer4"]["ids"]) == min(k, 70)
    finally:
        jserver.shutdown()
        jserver.server_close()
        jthread.join(timeout=10)


def _image_bytes(fmt: str) -> bytes:
    """The JPEG test image re-encoded as PNG (RGBA), BMP (palette), CMYK JPEG or WebP (lossy with alpha, or
    lossless), the formats PIL uploads take."""
    import io

    from PIL import Image

    image = Image.open(io.BytesIO(_jpeg_bytes(seed=6, size=(41, 33)))).convert("RGB")
    buf = io.BytesIO()
    if fmt == "png":
        image.convert("RGBA").save(buf, "PNG")
    elif fmt == "bmp":
        image.quantize(64).save(buf, "BMP")
    elif fmt == "webp-lossy":
        image.convert("RGBA").save(buf, "WEBP", quality=80)
    elif fmt == "webp-lossless":
        image.save(buf, "WEBP", lossless=True)
    else:
        image.convert("CMYK").save(buf, "JPEG", quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", ["png", "bmp", "cmyk", "webp-lossy", "webp-lossless"])
def test_http_image_search_other_formats_match_jax_server(http, fms, fmt):
    """POST /image_search with a PNG, a BMP, a CMYK JPEG or a WebP: the port picks the decoder by content and
    decodes to PIL's array, as the JAX server does with PIL; ids equal, scores within 1e-5."""
    jfm, _ = fms
    service, base = http
    jservice = jserve.SearchService(jfm, service.banks, templates=TEMPLATES)
    jserver, jthread = jserve.serve(jservice, port=0, background=True)
    try:
        data = _image_bytes(fmt)
        results = {}
        for name, url in (("torch", base), ("jax", f"http://127.0.0.1:{jserver.server_address[1]}")):
            request = urllib.request.Request(f"{url}/image_search?k=5", data=data, method="POST")
            status, out = _status(request)
            assert status == 200, (name, out)
            results[name] = out["results"]
        _assert_same_results(results["torch"], results["jax"])
    finally:
        jserver.shutdown()
        jserver.server_close()
        jthread.join(timeout=10)


def test_http_concurrent_clients(http):
    """8 clients at once, each a few text and label requests: every answer equals the
    sequential one."""
    service, base = http
    queries = ["dog", "cat", "tree", "sky", "boat", "red car", "dog", "sky"]
    expected = {q: service.text_search(q, k=5) for q in set(queries)}
    label_expected = service.label(WORDS, 2, 8)
    results, errors = [None] * len(queries), []

    def client(i):
        try:
            got = [_get(f"{base}/text_search?q={urllib.parse.quote(queries[i])}&k=5")[1]["results"]
                   for _ in range(3)]
            words = urllib.parse.quote(",".join(WORDS))
            got.append(_get(f"{base}/label?words={words}&top_m=2&max_components=8")[1]["results"])
            results[i] = got
        except Exception as exc:  # raised again in the test thread
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    for q, got in zip(queries, results):
        assert got[:3] == [expected[q]] * 3 and got[3] == label_expected


# --------------------------------------------------------------------------- #
# The command line
# --------------------------------------------------------------------------- #
def test_cli_loads_a_concept_db_written_by_the_jax_package(tmp_path):
    from safetensors.numpy import save_file

    rng = np.random.default_rng(3)
    raw = {"layer3": rng.normal(size=(6, 4, 16)).astype(np.float32),
           "layer4": rng.normal(size=(9, 16)).astype(np.float32)}
    path = tmp_path / "concept_db-x.safetensors"
    save_file(raw, str(path))
    agg = tserve.load_aggregated_db(path)
    np.testing.assert_array_equal(agg["layer3"], raw["layer3"].mean(1))
    np.testing.assert_array_equal(agg["layer4"], raw["layer4"])
    from semanticlens_tpu_torch.foundation_models import mobileclip as tmc
    from semanticlens_tpu_torch.foundation_models import siglip as tsig

    # --fm siglip2 / mobileclip-s1 build those families (cut-down presets here), --bpe becoming SigLIP's
    # tokenizer_path, and serve the DB.
    served = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tsig.SIGLIP_PRESETS, "ViT-B-16-SigLIP2", tsig.SigLIPConfig(
            embed_dim=16, image_size=16, patch_size=8, vision_width=16, vision_layers=1, vision_heads=2,
            text_width=16, text_layers=1, text_heads=2, vocab_size=64, context_length=8))
        mp.setitem(tmc.MOBILECLIP_PRESETS, "MobileCLIP-S1", tmc.MobileCLIPConfig(
            embed_dim=16, image_size=32, depths=(1, 1, 1, 1), dims=(8, 16, 24, 32), attn_heads=2,
            text=tclip.TextCfg(context_length=8, vocab_size=64, width=16, heads=2, layers=1)))
        mp.setattr(tserve, "serve", lambda service, port: served.append(service))
        for family, cls in (("siglip2", tsig.SigLipV2), ("ViT-B-16-SigLIP2", tsig.SigLipV2),
                            ("mobileclip-s1", tmc.ClipMobile)):
            tserve.main(["--db", str(path), "--fm", family, "--device", "cpu"])
            assert type(served[-1].fm) is cls and served[-1].fm.device == torch.device("cpu")
            assert len(served[-1].text_search("a dog", 3)["layer4"]["ids"]) == 3
        from semanticlens_tpu_torch.foundation_models.sentencepiece import SigLipTokenizer, SpModel, serialize_model

        (tmp_path / "toy.model").write_bytes(serialize_model(SpModel(pieces=[("<unk>", 0.0, 2), ("▁a", -1.0, 1)])))
        tserve.main(["--db", str(path), "--fm", "siglip2", "--bpe", str(tmp_path / "toy.model"), "--device", "cpu"])
        assert isinstance(served[-1].fm.tokenizer, SigLipTokenizer)
    with pytest.raises(ValueError, match="Unsupported checkpoint"):
        tserve.main(["--db", str(path), "--checkpoint", str(tmp_path / "w.pt"), "--device", "cpu"])


def test_cli_checkpoint_files_load_as_open_clip_state_dicts(tmp_path):
    from semanticlens_tpu_torch.utils import safetensors_io

    state = {"visual.proj": torch.arange(6, dtype=torch.float32).reshape(2, 3), "logit_scale": torch.tensor(2.0)}
    safetensors_io.save_file(state, tmp_path / "w.safetensors")
    np.savez(tmp_path / "w.npz", **{k: v.numpy() for k, v in state.items()})
    for name in ("w.safetensors", "w.npz"):
        loaded = tclip._load_checkpoint(tmp_path / name)  # the CLI's loader: OpenClip(checkpoint=)
        assert loaded.keys() == state.keys()
        for key in state:
            assert torch.equal(loaded[key], state[key])
