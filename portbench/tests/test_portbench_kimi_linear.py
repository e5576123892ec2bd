"""The Kimi Linear cell's yardstick on the CPU at a tiny size: its reference, its arithmetic, and a whole run of a
cut-down text sweep, sound and with faults planted.

- ``reference/kimi_linear.py``, drawing and running one layer at a time
  (the held experts only), equals the test tree's plain reference
  (``tests/plain/kimi_linear.py``) run all at once on the same weights;
- the FLOP counters give the published share's 2.48 G multiply-accumulates
  a token at 2,048 tokens, and the KDA recurrence's least work and bytes;
- a tiny ``textsweep`` cell (four layers: KDA, MLA, KDA, MLA; 8 of 16
  experts held, top-4; taps a KDA layer's neurons and its MoE layer's held
  experts; a one-block CLIP text tower; float32) comes out
  correct, and not correct with the KDA decay removed, the KDA state reset
  every 8 tokens, or the routers' correction bias dropped (planted by
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

from portbench.harness.bench import load_module
from portbench.reference import kimi_linear

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
TINY = {"hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 16, "num_experts": 8,
        "num_experts_published": 16, "held_experts": [0, 8], "num_experts_per_token": 4, "num_shared_experts": 1,
        "num_hidden_layers": 4, "num_attention_heads": 4, "num_key_value_heads": 4, "kv_lora_rank": 32,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "vocab_size": 160, "model_max_length": 64,
        "fm_words": 6, "linear_attn_config": {"full_attn_layers": [2, 4], "head_dim": 16, "num_heads": 2,
                                              "kda_layers": [1, 3], "short_conv_kernel_size": 4}}
TINY_FM = {"embed_dim": 32, "vision": {"image_size": 32, "patch_size": 16, "width": 32, "layers": 1, "heads": 2},
           "text": {"context_length": 16, "vocab_size": 1000, "width": 32, "heads": 2, "layers": 1}}
# the KDA layer's neurons and, at the tiny depth where one MoE layer precedes it, the tapped layer's own held experts
# (their activity follows its routing, so the bias fault shows there)
TAPS = ("model.layers.2.self_attn.o_norm", "model.layers.2.mlp.experts.act_fn")
RESET_EVERY = 8  # the planted chunk-carry fault's period at the tiny size (64 on the card)


def _plain():
    spec = importlib.util.spec_from_file_location("plain_kimi_linear", ROOT / "tests/plain/kimi_linear.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tiny_config() -> dict:
    cfg = json.loads((ROOT / "portbench/configs/kimilinear-clip-b32.json").read_text())
    cfg.update(TINY, name="tiny-kimi", dtype="float32", components={TAPS[0]: 32, TAPS[1]: 8 * 16})
    cfg["fm"].update(TINY_FM)
    return cfg


def test_layer_by_layer_reference_equals_the_plain_one():
    cfg, seed = tiny_config(), 2**31 + 5
    sd = kimi_linear.draw_outer(cfg, seed, CPU, torch.float32)
    for i in range(cfg["num_hidden_layers"]):
        sd.update(kimi_linear.draw_layer(cfg, i, seed, CPU, torch.float32))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 160, size=(5, 20)))
    plain_cfg = {**cfg, "num_experts": cfg["num_experts_published"]}  # the plain reference's router width
    taps = TAPS + ("model.layers.1", "model.layers.1.mlp.gate")
    with torch.no_grad():
        _, want_taps, _ = _plain().forward(sd, tokens, plain_cfg, range(*cfg["held_experts"]))
        got = kimi_linear.token_means(cfg, seed, CPU, tokens, taps, torch.float32)
    for name in taps:
        want = want_taps[name].mean(dim=1)
        # float32 both, the same equations in other orders (per-sequence sums against a token mean)
        torch.testing.assert_close(got[name], want, atol=1e-5 * float(want.abs().max()), rtol=0)


def test_arithmetic_of_the_published_share():
    program = load_module(ROOT / "portbench/configs/kimilinear-clip-b32.program.py", "kimi_program_for_tests")
    cfg = json.loads((ROOT / "portbench/configs/kimilinear-clip-b32.json").read_text())
    assert program.active_macs_per_token(cfg, 2048) == pytest.approx(2.48e9, rel=0.01)
    assert program.flops_per_image(cfg, 2048) == pytest.approx(10.17e12, rel=0.01)
    assert program.kda_flops_per_token_head(cfg) == 7 * 128**2
    assert program.kda_bytes_per_token_head(cfg) == 2 * (5 * 128 + 1)
    # the weights drawn for a layer are the held experts' only, HF's shapes
    specs = {name: shape for name, shape, _ in kimi_linear.layer_specs(cfg, 13)}
    assert "model.layers.13.mlp.experts.127.up_proj.weight" in specs
    assert "model.layers.13.mlp.experts.128.up_proj.weight" not in specs
    assert specs["model.layers.13.mlp.gate.weight"] == (256, 2304)
    assert [i for i in range(27) if kimi_linear.is_mla(cfg, i)] == [3, 7, 11, 15, 19, 23, 26]


@pytest.fixture(scope="module")
def kimi_root(tmp_path_factory) -> Path:
    root = make_tiny_root(tmp_path_factory.mktemp("kimi"))
    bd = root / "portbench"
    (bd / "configs/tiny-kimi.json").write_text(json.dumps(tiny_config()))
    for part in ("program", "reference"):
        shutil.copy(bd / f"configs/kimilinear-clip-b32.{part}.py", bd / f"configs/tiny-kimi.{part}.py")
    (bd / "traffic/tiny-textsweep-kimi.json").write_text(json.dumps(
        {"kind": "textsweep", "sequences": 40, "seq_len": 40, "batch_size": 16, "num_samples": 5,
         "check_components": 8, "zipf_s": 1.1, "topics": 4, "topic_vocab": 16, "topic_share": 0.5}))
    shutil.copy(bd / "checks/kimilinear-clip-b32.textsweep.json", bd / "checks/tiny-kimi.textsweep.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-kimi", "source": "a cut-down copy for tests", "reduced": [],
                            "file": "portbench/configs/tiny-kimi.json", "why": "tests on the CPU"})
    spec["workloads"].append({"name": "tiny-kimi.textsweep", "config": "tiny-kimi", "traffic": "tiny-textsweep-kimi",
                              "chips": 1, "why": "tests"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "kimilinear-clip-b32.textsweep" in metric.get("workloads", []):
            metric["workloads"].append("tiny-kimi.textsweep")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_tiny_text_sweep_is_correct(kimi_root):
    line, run = run_cell(kimi_root, "tiny-kimi.textsweep", trace=True)
    assert line["correct"], line["checks"]
    assert run.counters["sweeps"] >= 3 and run.attempted == run.counters["sweeps"]
    line, _ = run_cell(kimi_root, "tiny-kimi.textsweep")
    assert set(line["metrics"]) == {"images_per_s", "setup_s"} and line["correct"]


def _no_decay(monkeypatch):
    from semanticlens_tpu_torch.ops import kda

    recurrence = kda.recurrence
    monkeypatch.setattr(kda, "recurrence", lambda q, k, v, g, beta: recurrence(q, k, v, torch.zeros_like(g), beta))


def _state_reset(monkeypatch):
    from semanticlens_tpu_torch.ops import kda

    recurrence = kda.recurrence

    def chunked(q, k, v, g, beta):
        parts = [recurrence(*(x[:, s : s + RESET_EVERY] for x in (q, k, v, g, beta)))
                 for s in range(0, q.shape[1], RESET_EVERY)]
        return torch.cat(parts, dim=1)

    monkeypatch.setattr(kda, "recurrence", chunked)


def _no_correction_bias(monkeypatch):
    from semanticlens_tpu_torch.ops import moe

    route = moe.route
    monkeypatch.setattr(moe, "route", lambda x, gate, k, correction_bias=None, **kw: route(x, gate, k, **kw))


@pytest.mark.parametrize("plant", [_no_decay, _state_reset, _no_correction_bias],
                         ids=["no KDA decay", "KDA state reset", "no correction bias"])
def test_tiny_text_sweep_catches_a_planted_fault(kimi_root, monkeypatch, plant):
    plant(monkeypatch)
    line, _ = run_cell(kimi_root, "tiny-kimi.textsweep")
    assert not line["correct"] and line["failed"] == 1, line["checks"]
