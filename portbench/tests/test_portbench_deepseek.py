"""The DeepSeek-V2 cell's yardstick on the CPU at a tiny size: its reference, its corpus, its arithmetic, and a
whole run of a cut-down text sweep, sound and with faults planted.

- ``reference/deepseek_v2.py``, drawing and running one layer at a time,
  equals the test tree's plain reference (``tests/plain/deepseek_v2.py``)
  run all at once on the same weights;
- the corpus' FM token rows are what the port's hash tokenizer makes of
  its strings;
- the FLOP counters give the published model's 2.45 G multiply-accumulates
  a token;
- a tiny ``textsweep`` cell (a three-layer DeepSeek-V2 with 8 experts, a
  one-block CLIP text tower, float32) comes out correct, and not correct
  with its routing cut to top-1 or its shared experts dropped (planted by
  replacing the program's functions for the run).
"""

from __future__ import annotations

import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import make_tiny_root, run_cell

from portbench.harness import text_inputs
from portbench.harness.bench import load_module
from portbench.reference import deepseek_v2

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
TINY = {"hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 16, "n_routed_experts": 8,
        "num_experts_per_tok": 2, "n_shared_experts": 1, "num_hidden_layers": 3, "num_attention_heads": 4,
        "num_key_value_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
        "v_head_dim": 16, "vocab_size": 160, "max_position_embeddings": 64, "fm_words": 6,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 4, "mscale": 0.707, "mscale_all_dim": 0.707,
                         "original_max_position_embeddings": 64, "type": "yarn"}}
TINY_FM = {"embed_dim": 32, "vision": {"image_size": 32, "patch_size": 16, "width": 32, "layers": 1, "heads": 2},
           "text": {"context_length": 16, "vocab_size": 1000, "width": 32, "heads": 2, "layers": 1}}
TAPS = ("model.layers.2.mlp.experts.act_fn", "model.layers.2.mlp.gate")


def _plain():
    spec = importlib.util.spec_from_file_location("plain_deepseek_v2", ROOT / "tests/plain/deepseek_v2.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tiny_config() -> dict:
    cfg = json.loads((ROOT / "portbench/configs/dsv2lite-clip-b32.json").read_text())
    cfg.update(TINY, name="tiny-ds", dtype="float32", components={TAPS[0]: 128, TAPS[1]: 8})
    cfg["fm"].update(TINY_FM)
    return cfg


def test_layer_by_layer_reference_equals_the_plain_one():
    cfg, seed = tiny_config(), 2**31 + 5
    sd = deepseek_v2.draw_outer(cfg, seed, CPU, torch.float32)
    for i in range(cfg["num_hidden_layers"]):
        sd.update(deepseek_v2.draw_layer(cfg, i, seed, CPU, torch.float32))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 160, size=(5, 12)))
    with torch.no_grad():
        _, taps, _ = _plain().forward(sd, tokens, cfg)
        got = deepseek_v2.token_means(cfg, seed, CPU, tokens, TAPS + ("model.layers.1",), torch.float32)
    for name in TAPS + ("model.layers.1",):
        want = taps[name].mean(dim=1)
        # float32 both, the same equations in other orders (per-sequence sums against a token mean)
        torch.testing.assert_close(got[name], want, atol=1e-5 * float(want.abs().max()), rtol=0)


def test_corpus_rows_are_the_hash_tokenizers():
    from semanticlens_tpu_torch.foundation_models.tokenizer import HashTokenizer

    mix = {"sequences": 6, "seq_len": 40, "zipf_s": 1.1, "topics": 2, "topic_vocab": 32, "topic_share": 0.5}
    rows, strings = text_inputs.corpus(2**31 + 9, mix, 160, 30)
    assert rows.shape == (6, 40) and rows.dtype == np.int32 and rows.max() < 160
    want = HashTokenizer(1000, 16)(strings)  # 30 words cut to the context's 16 tokens, the end token last
    np.testing.assert_array_equal(text_inputs.fm_token_rows(2**31 + 9, rows, 30, 160, 1000, 16), want)
    again, _ = text_inputs.corpus(2**31 + 9, mix, 160, 30)
    np.testing.assert_array_equal(rows, again)


def test_flops_of_the_published_model():
    program = load_module(ROOT / "portbench/configs/dsv2lite-clip-b32.program.py", "dsv2lite_program_for_tests")
    cfg = json.loads((ROOT / "portbench/configs/dsv2lite-clip-b32.json").read_text())
    assert program.active_macs_per_token(cfg) == pytest.approx(2.45e9, rel=0.01)
    assert program.flops_per_image(cfg, 512) == pytest.approx(2.54e12, rel=0.01)
    assert program.expert_flops_per_pair(cfg) == 2 * 3 * 2048 * 1408


@pytest.fixture(scope="module")
def ds_root(tmp_path_factory) -> Path:
    root = make_tiny_root(tmp_path_factory.mktemp("ds"))
    bd = root / "portbench"
    (bd / "configs/tiny-ds.json").write_text(json.dumps(tiny_config()))
    for part in ("program", "reference"):
        shutil.copy(bd / f"configs/dsv2lite-clip-b32.{part}.py", bd / f"configs/tiny-ds.{part}.py")
    (bd / "traffic/tiny-textsweep.json").write_text(json.dumps(
        {"kind": "textsweep", "sequences": 40, "seq_len": 12, "batch_size": 16, "num_samples": 5,
         "check_components": 8, "zipf_s": 1.1, "topics": 4, "topic_vocab": 16, "topic_share": 0.5}))
    shutil.copy(bd / "checks/dsv2lite-clip-b32.textsweep.json", bd / "checks/tiny-ds.textsweep.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-ds", "source": "a cut-down copy for tests", "reduced": [],
                            "file": "portbench/configs/tiny-ds.json", "why": "tests on the CPU"})
    spec["workloads"].append({"name": "tiny-ds.textsweep", "config": "tiny-ds", "traffic": "tiny-textsweep",
                              "chips": 1, "why": "tests"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "dsv2lite-clip-b32.textsweep" in metric.get("workloads", []):
            metric["workloads"].append("tiny-ds.textsweep")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_tiny_text_sweep_is_correct(ds_root):
    line, run = run_cell(ds_root, "tiny-ds.textsweep", trace=True)
    assert line["correct"], line["checks"]
    assert run.counters["sweeps"] >= 3 and run.attempted == run.counters["sweeps"]
    line, _ = run_cell(ds_root, "tiny-ds.textsweep")
    assert set(line["metrics"]) == {"images_per_s", "setup_s"} and line["correct"]


def _top_one(monkeypatch):
    from semanticlens_tpu_torch.ops import moe

    route = moe.route
    monkeypatch.setattr(moe, "route", lambda x, gate, k, **kw: route(x, gate, k - 1, **kw))


def _no_shared_experts(monkeypatch):
    from semanticlens_tpu_torch.models import DeepseekV2

    swiglu = DeepseekV2._swiglu

    def dropped(self, tap, params, prefix, x):
        out = swiglu(self, tap, params, prefix, x)
        return out * 0 if prefix.endswith("shared_experts") else out

    monkeypatch.setattr(DeepseekV2, "_swiglu", dropped)


@pytest.mark.parametrize("plant", [_top_one, _no_shared_experts], ids=["top-1 routing", "shared experts dropped"])
def test_tiny_text_sweep_catches_a_planted_fault(ds_root, monkeypatch, plant):
    plant(monkeypatch)
    line, _ = run_cell(ds_root, "tiny-ds.textsweep")
    assert not line["correct"] and line["failed"] == 1
