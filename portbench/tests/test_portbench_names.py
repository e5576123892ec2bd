"""``BENCHMARK.json`` keeps to the benchmark contract's form, and every name it uses has its files."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench.harness.bench import Benchmark

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(_dim|_rank)$|width|hidden|intermediate|latent|state|proj|head|expansion|experts_per_tok")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])


@pytest.mark.parametrize("section", list(KEYS))
def test_entries(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for entry in SPEC[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(entry) <= KEYS[section] | extra, entry["name"]
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer") + (("source",) if section == "configs" else ()):
            if key in entry:
                assert _line(entry[key]), (entry["name"], key)


def test_configs_and_their_files():
    for c in SPEC["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] and _line(cfg["source"])
        for part in ("program", "reference"):
            assert (ROOT / c["file"]).with_suffix(f".{part}.py").is_file()
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])


def test_workloads_and_their_files():
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and NAME.match(w["traffic"])
        mix = json.loads((ROOT / "portbench/traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "portbench/kinds" / f"{mix['kind']}.py").is_file()
        limits = json.loads((ROOT / "portbench/checks" / f"{w['name']}.json").read_text())
        assert limits and set(limits) <= set(Benchmark(ROOT).kind(mix["kind"]).NUMBERS)
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)


def test_metrics():
    workloads = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", workloads)) <= workloads
    for w in workloads:
        reported = [m for m in SPEC["end_to_end"] if w in m.get("workloads", [w])]
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert any(w in m.get("workloads", [w]) for m in SPEC["per_layer"])
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and set(m["workloads"]) <= workloads
        assert all(w in e2e[m["moves"]].get("workloads", [w]) for w in m["workloads"])
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(spellings) == 1 for spellings in layers.values())
    roofline_moves = {m["moves"] for m in SPEC["per_layer"] if "roofline" in m["name"]}
    mfu_moves = {m["moves"] for m in SPEC["per_layer"] if "mfu" in m["name"]}
    assert roofline_moves <= mfu_moves


def test_file_names_use_name_characters():
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts or ".cache" in path.parts:
            continue
        assert PATH.match(str(path.relative_to(ROOT))), path
