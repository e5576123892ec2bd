"""The result line has exactly the contract's keys, the checked numbers come last, and a run without the
card or without the program prints no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, run_cell

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["tiny-rn.sweep", "tiny-vit.sweep", "tiny-rn.search"])
@pytest.mark.parametrize("trace", [False, True])
def test_line_keys(tiny_root, workload, trace):
    line, run = run_cell(tiny_root, workload, trace=trace)
    assert list(line) == CONTRACT + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    expect = run.bench.metrics_of(workload, "per_layer" if trace else "end_to_end")
    assert set(line["metrics"]) <= {m["name"] for m in expect}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"} and line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        assert set(line["metrics"]) == {m["name"] for m in expect}
        assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    assert set(line["checks"]) == set(run.bench.limits(workload))
    json.dumps(line)


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "rn50-clip-b32.sweep", "--seed",
                           str(2**31 + 3), "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    if proc.returncode == 0:
        pytest.skip("this machine has a CUDA card")
    assert proc.stdout == "" and "CUDA" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "rn50-clip-b32.search", "--seed", "5",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""
