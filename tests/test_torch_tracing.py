"""The port's tracer (``utils/profiling.py``: ``span``, ``count``, ``tally``, ``snapshot``) and the spans the
program opens.

Off, a span is one shared no-op context and records nothing; on, a tiny
fused sweep records every Collect, Embed and concept-DB span, a chunked
search one K1 and one merge span a chunk, a DeepSeek-V2 forward its MLA
and MoE spans, a text sweep its text-tower span, and under
``torch.profiler`` each span is a ``semanticlens.<name>`` annotation around
the operators of its work. Counters (the K1 launches, the search's
stable-sort fallbacks, the routed pairs) count whether spans are on or off,
and are read without waiting for the card; tallies (the MoE layers' tokens
per expert) are kept unread and resolved by ``snapshot``.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from semanticlens_tpu_torch import Lens
from semanticlens_tpu_torch.collect import ActivationComponentVisualizer, CollectEngine
from semanticlens_tpu_torch.data import ArrayDataset
from semanticlens_tpu_torch.foundation_models import clip as tclip
from semanticlens_tpu_torch.models import ResNet
from semanticlens_tpu_torch.ops import cosine
from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean
from semanticlens_tpu_torch.scores import topk_cosine_search
from semanticlens_tpu_torch.utils import (
    StageTimer,
    count,
    counters,
    device_trace,
    enable,
    enabled,
    make_preprocess_fn,
    profiling,
    reset,
    snapshot,
    span,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TINY_CLIP = tclip.CLIPConfig(
    embed_dim=16,
    vision=tclip.VisionCfg(image_size=16, patch_size=8, width=32, layers=2, heads=2),
    text=tclip.TextCfg(context_length=12, vocab_size=50, width=32, heads=2, layers=2),
)
N_IMAGES, BATCH = 28, 8  # four batches, the last one padded
SWEEP_SPANS = {"collect.init", "collect.upload", "collect.preprocess", "collect.forward", "collect.topk",
               "collect.drain", "embed.preprocess", "embed.encode", "concept_db.ingest", "concept_db.gather"}


@pytest.fixture
def tracer():
    """Spans on and everything cleared; afterwards the switch as it was and nothing left recorded."""
    was = enabled()
    reset()
    enable()
    yield
    enable(was)
    reset()


@pytest.fixture
def tracer_off():
    was = enabled()
    reset()
    enable(False)
    yield
    enable(was)
    reset()


def test_off_is_one_shared_no_op_that_records_nothing(tracer_off, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span that is off touched the card or the profiler")

    monkeypatch.setattr(profiling, "_Span", refuse)  # no span object, so no event and no annotation
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = span("a", torch.device("cuda"))
    assert first is span("b") is profiling._OFF
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(100):
            with span("a", torch.device("cuda")):
                pass
    assert snapshot()["spans"] == {}


def test_env_switch_is_read_at_import():
    code = "from semanticlens_tpu_torch.utils import profiling; print(profiling.enabled())"
    for value, want in (("1", "True"), ("0", "False")):
        env = {**os.environ, "SEMANTICLENS_TRACE": value}
        out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip().splitlines()[-1] == want


def _sweep_objects(images):
    model = ResNet(depth=18, dtype=torch.float32, device="cpu")
    model.params = model.load_jax_params(model.init_jax_layout(seed=0))
    model.name = "resnet18-toy"
    fm = tclip.OpenClip("ViT-B-32", jax_params=tclip.init_clip_params_jax_layout(1, TINY_CLIP),
                        dtype=torch.float32, device="cpu", cfg=TINY_CLIP)
    dataset = ArrayDataset(images, name="toy")
    cv = ActivationComponentVisualizer(model=model, dataset_model=dataset, dataset_fm=dataset,
                                       layer_names=["layer3", "layer4"], num_samples=4,
                                       aggregate_fn=aggregate_conv_mean, model_preprocess=make_preprocess_fn(size=32))
    return cv, Lens(fm)


@pytest.mark.parametrize("path", ["fused", "collect"])
def test_a_sweep_records_its_spans_and_batches(tracer, path):
    images = np.random.default_rng(0).integers(0, 256, size=(N_IMAGES, 40, 48, 3), dtype=np.uint8)
    cv, lens = _sweep_objects(images)
    batches = -(-N_IMAGES // BATCH)
    if path == "fused":
        db = lens.compute_concept_db(cv, batch_size=BATCH)
        assert counters()["concept_db.bytes"] == sum(v.nbytes for v in db.values())
    else:
        cv.run(batch_size=BATCH)
    spans = snapshot()["spans"]
    assert spans["fm.load"]["calls"] == 1
    assert spans["collect.init"]["calls"] == 1
    assert spans["collect.upload"]["calls"] == spans["collect.topk"]["calls"] == batches
    assert spans["collect.forward"]["calls"] == spans["collect.preprocess"]["calls"] == batches
    if path == "fused":
        assert SWEEP_SPANS <= set(spans)
        assert spans["embed.encode"]["calls"] == spans["embed.preprocess"]["calls"] == batches
        assert spans["concept_db.gather"]["calls"] == spans["concept_db.ingest"]["calls"] == 1
    else:
        assert not {"embed.encode", "concept_db.gather"} & set(spans)
    for name, s in spans.items():
        assert s["host_ms"] > 0 and len(s["recent_host_ms"]) == s["calls"], name
        assert s["device_ms"] is None and s["recent_device_ms"] == [], name  # no CUDA events on the CPU


@pytest.mark.parametrize("sweep", ["collect", "fused", "embed"])
def test_each_sweep_is_the_engine_loop_with_one_forward_a_batch(tracer, monkeypatch, sweep):
    """The Collect, fused and embed-only sweeps all run ``CollectEngine._sweep``, and each runs its subject
    and/or FM forward once a batch and no other: the top-k states are sized from the first batch."""
    images = np.random.default_rng(3).integers(0, 256, size=(N_IMAGES, 40, 48, 3), dtype=np.uint8)
    cv, lens = _sweep_objects(images)
    loops, loop = [], CollectEngine._sweep
    monkeypatch.setattr(CollectEngine, "_sweep", lambda self, *a, **k: loops.append(self) or loop(self, *a, **k))
    if sweep == "collect":
        cv.run(batch_size=BATCH)
    elif sweep == "fused":
        lens.compute_concept_db(cv, batch_size=BATCH)
    else:
        assert cv._embed_vision_dataset(lens.fm, BATCH, checkpoint=0).shape == (N_IMAGES, TINY_CLIP.embed_dim)
    batches, subject, fm = -(-N_IMAGES // BATCH), sweep != "embed", sweep != "collect"
    spans = snapshot()["spans"]
    calls = {name: spans.get(name, {}).get("calls", 0)
             for name in ("collect.upload", "collect.init", "collect.forward", "embed.encode")}
    assert calls == {"collect.upload": batches, "collect.init": int(subject), "collect.forward": batches * subject,
                     "embed.encode": batches * fm}
    assert loops == [cv.engine]


def test_a_chunked_search_records_each_chunk(tracer):
    g = torch.Generator().manual_seed(0)
    bank, queries = torch.randn(40, 12, generator=g), torch.randn(5, 12, generator=g)
    topk_cosine_search(queries, bank, 3, chunk_size=10, device="cpu")
    spans = snapshot()["spans"]
    assert {name: s["calls"] for name, s in spans.items()} == {
        "search.call": 1, "search.prepare": 1, "search.k1": 4, "search.merge": 4, "search.tie_test": 4}


@pytest.mark.parametrize("zero_rows", [0, 36])
def test_tie_fallbacks_count_the_stable_sorts(tracer_off, zero_rows):
    g = torch.Generator().manual_seed(1)
    bank, queries = torch.randn(40, 12, generator=g), torch.randn(5, 12, generator=g)
    bank[40 - zero_rows:] = 0.0  # dead rows all score exactly 0: ties across the k-th value
    vals, idx = topk_cosine_search(queries, bank, 8, device="cpu")
    fallbacks = snapshot()["counters"].get("search.tie_fallbacks", 0)
    assert (fallbacks > 0) == (zero_rows > 0)
    dense = cosine.cosine_similarity_matrix_plain(queries, bank)
    want = torch.sort(dense, dim=1, descending=True, stable=True)
    torch.testing.assert_close(vals, want.values[:, :8])
    np.testing.assert_array_equal(idx.numpy(), want.indices[:, :8].numpy())


def test_spans_annotate_the_operators_they_enclose(tracer, tmp_path):
    g = torch.Generator().manual_seed(2)
    bank, queries = torch.randn(64, 16, generator=g), torch.randn(4, 16, generator=g)
    with device_trace(str(tmp_path)):
        topk_cosine_search(queries, bank, 4, chunk_size=32, device="cpu")
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"] if e.get("ph") == "X"]
    ours = [e for e in events if e["name"].startswith("semanticlens.")]
    assert ours and all(e["cat"] == "user_annotation" for e in ours)
    assert {e["name"] for e in ours} == {"semanticlens.search.call", "semanticlens.search.prepare",
                                         "semanticlens.search.k1", "semanticlens.search.merge",
                                         "semanticlens.search.tie_test"}

    def enclosed(span_name, op):
        return [o for s in ours if s["name"] == span_name for o in events
                if o["cat"] == "cpu_op" and o["name"] == op and s["ts"] <= o["ts"]
                and o["ts"] + o["dur"] <= s["ts"] + s["dur"]]

    assert len(enclosed("semanticlens.search.k1", "aten::matmul")) == 2
    assert len(enclosed("semanticlens.search.merge", "aten::topk")) == 2
    assert len(enclosed("semanticlens.search.tie_test", "aten::equal")) == 2


def test_snapshot_stays_bounded_and_reset_clears_it(tracer):
    n = profiling.KEEP + 904
    for _ in range(n):
        with span("x"):
            pass
    count("c", 3)
    with StageTimer().stage("scores"):
        pass
    snap = snapshot()
    x = snap["spans"]["x"]
    assert x["calls"] == n and len(x["recent_host_ms"]) == profiling.KEEP
    assert x["host_ms"] >= sum(x["recent_host_ms"])
    assert snap["spans"]["stage.scores"]["calls"] == 1 and snap["counters"] == {"c": 3}
    reset()
    assert snapshot() == {"spans": {}, "counters": {}}


def test_launch_counts_read_the_tracer_counters(tracer_off):
    count("k1.launches.tiled", 2)
    count("k1.launches.streaming")
    count("search.tie_fallbacks", 5)
    assert cosine.launch_counts() == {"streaming": 1, "tiled": 2, "total": 3}
    cosine.reset_launch_counts()
    assert cosine.launch_counts() == {"streaming": 0, "tiled": 0, "total": 0}
    assert snapshot()["counters"] == {"search.tie_fallbacks": 5}


def test_counters_do_not_wait_for_the_card(tracer, monkeypatch):
    with span("x"):
        count("k1.launches.tiled")

    def no_wait(wait):
        raise AssertionError("counters resolved the pending events")

    monkeypatch.setattr(profiling, "_resolve", no_wait)
    assert counters() == {"k1.launches.tiled": 1}
    assert cosine.launch_counts()["total"] == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: device spans time CUDA events")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_device_spans_time_the_card_and_stay_bounded(tracer, cuda_device, monkeypatch):
    monkeypatch.setattr(profiling, "KEEP", 8)
    x = torch.randn(2048, 2048, device=cuda_device)
    x = x @ x / 2048.0  # cuBLAS set up outside the spans: a span also holds the card's idle time inside it
    torch.cuda.synchronize()
    for _ in range(40):
        with span("card.mm", cuda_device):
            x = x @ x / 2048.0
        assert len(profiling._pending) <= 2 * 8 + 1
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(40):
        x = x @ x / 2048.0
    stop.record()
    stop.synchronize()
    s = snapshot()["spans"]["card.mm"]
    assert not profiling._pending
    assert s["calls"] == 40 and len(s["recent_device_ms"]) == 8 and min(s["recent_device_ms"]) > 0
    assert 0.5 < s["device_ms"] / start.elapsed_time(stop) < 2.0  # the spans hold the same work, timed alike


def _tiny_deepseek():
    from test_torch_deepseek_v2 import hf_weights, port_model

    model = port_model()
    return model, model.load_torch_state_dict(hf_weights())


EXPERTS_TAP = "model.layers.2.mlp.experts.act_fn"


def test_mla_and_moe_spans_open_under_enable(tracer):
    model, params = _tiny_deepseek()
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 160, size=(2, 12)))
    with torch.no_grad():
        model.apply(params, toks)
        model.apply(params, toks, [EXPERTS_TAP])
    spans = snapshot()["spans"]
    calls = {name: spans[name]["calls"] for name in spans}
    # two forwards of three layers: MLA in each layer, the MoE spans in layers 1 and 2, the tap's once
    assert calls == {"mla.attention": 6, "moe.route": 4, "moe.experts": 4, "moe.combine": 4, "moe.weighted_sum": 4,
                     "moe.tap": 1}


def test_routed_pairs_count_b_t_k_per_moe_layer(tracer_off):
    model, params = _tiny_deepseek()
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 160, size=(3, 12)))
    with torch.no_grad():
        model.apply(params, toks)
    assert counters() == {"moe.routed_pairs": 2 * 3 * 12 * 2}  # two MoE layers, B·T tokens, top-2


def test_expert_load_resolves_in_snapshot_and_the_layer_reads_nothing_back(tracer_off, monkeypatch):
    from semanticlens_tpu_torch.ops import moe

    model, params = _tiny_deepseek()
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 160, size=(2, 12)))

    def refuse(*args, **kwargs):
        raise AssertionError("the MoE layer read a tensor back or waited for the card")

    with torch.no_grad(), monkeypatch.context() as m:
        m.setattr(moe, "expert_ffn", functools.partial(moe.expert_ffn, grouped=True))  # the card's path
        for name in ("item", "cpu", "tolist", "numpy"):
            m.setattr(torch.Tensor, name, refuse)
        m.setattr(torch.cuda, "synchronize", refuse)
        m.setattr(profiling, "_resolve", refuse)
        _, taps = model.apply(params, toks, [EXPERTS_TAP])
    snap = snapshot()
    assert set(snap["tallies"]) == {"moe.expert_load.1", "moe.expert_load.2"}
    routed = taps[EXPERTS_TAP].view(2, 12, 8, 16).ne(0).any(dim=-1)
    assert snap["tallies"]["moe.expert_load.2"] == [routed.sum(dim=(0, 1)).tolist()]
    assert all(sum(call) == 2 * 12 * 2 for calls in snap["tallies"].values() for call in calls)
    reset("moe.expert_load.1")
    assert set(snapshot()["tallies"]) == {"moe.expert_load.2"}


def _tiny_kimi():
    from test_torch_kimi_linear import hf_weights, port_model

    model = port_model()
    return model, model.load_torch_state_dict(hf_weights())


def test_kda_spans_and_counters_open_under_enable(tracer):
    model, params = _tiny_kimi()
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 160, size=(2, 12)))
    with torch.no_grad():
        model.apply(params, toks)
    snap = snapshot()
    calls = {name: snap["spans"][name]["calls"] for name in snap["spans"]}
    # one forward of eight layers: KDA in six (the convolutions and the recurrence inside each), MLA in two, MoE
    # in seven
    assert calls == {"kda.attention": 6, "kda.short_conv": 6, "kda.recurrence": 6, "mla.attention": 2,
                     "moe.route": 7, "moe.experts": 7, "moe.combine": 7, "moe.weighted_sum": 7}
    assert snap["counters"] == {"kda.token_heads": 6 * 2 * 12 * 2, "moe.routed_pairs": 7 * 2 * 12 * 4}


def test_held_expert_layer_tallies_every_expert_and_reads_nothing_back(tracer_off, monkeypatch):
    from semanticlens_tpu_torch.ops import moe

    model, params = _tiny_kimi()  # 8 of 16 experts held
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 160, size=(2, 12)))

    def refuse(*args, **kwargs):
        raise AssertionError("a KDA or MoE layer read a tensor back or waited for the card")

    with torch.no_grad(), monkeypatch.context() as m:
        m.setattr(moe, "expert_ffn", functools.partial(moe.expert_ffn, grouped=True))  # the card's path
        for name in ("item", "cpu", "tolist", "numpy"):
            m.setattr(torch.Tensor, name, refuse)
        m.setattr(torch.cuda, "synchronize", refuse)
        m.setattr(profiling, "_resolve", refuse)
        logits, taps = model.apply(params, toks, ["model.layers.5.mlp.experts.act_fn"])
    assert torch.isfinite(logits).all()
    snap = snapshot()
    assert set(snap["tallies"]) == {f"moe.expert_load.{i}" for i in range(1, 8)}
    # the routing over all 16 experts, held or not: B·T·k pairs a call
    assert all(len(call) == 16 and sum(call) == 2 * 12 * 4 for calls in snap["tallies"].values() for call in calls)
    routed = taps["model.layers.5.mlp.experts.act_fn"].view(2, 12, 8, 16).ne(0).any(dim=-1)
    assert snap["tallies"]["moe.expert_load.5"][0][:8] == routed.sum(dim=(0, 1)).tolist()


def test_the_text_embed_opens_its_span_per_batch(tracer):
    from semanticlens_tpu_torch.collect import TextActivationComponentVisualizer, TokenTextDataset

    model, params = _tiny_deepseek()
    model.params, model.name = params, "tiny-deepseek"
    toks = np.random.default_rng(3).integers(0, 160, size=(10, 12)).astype(np.int32)
    ds = TokenTextDataset(toks, [f"text number {i}" for i in range(10)], name="toy-texts")
    fm = tclip.OpenClip("ViT-B-32", jax_params=tclip.init_clip_params_jax_layout(1, TINY_CLIP),
                        dtype=torch.float32, device="cpu", cfg=TINY_CLIP)
    cv = TextActivationComponentVisualizer(model, ds, ds.texts_view(), ["model.layers.1.mlp.gate"], 2)
    Lens(fm).compute_concept_db(cv, batch_size=4)
    assert snapshot()["spans"]["embed.encode_text"]["calls"] == 3
