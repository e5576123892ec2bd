"""A configuration, a traffic mix and a per-layer metric are added by new files and entries alone."""

from __future__ import annotations

import hashlib
import json
import shutil

from conftest import make_tiny_root, run_cell


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_from_files_only(tmp_path):
    root = make_tiny_root(tmp_path)
    before = _digests(root)
    bd = root / "portbench"
    # a configuration: its sizes, its program and its reference, under a new name
    cfg = json.loads((bd / "configs/tiny-rn.json").read_text())
    cfg.update(name="tiny-rn-new")
    (bd / "configs/tiny-rn-new.json").write_text(json.dumps(cfg))
    for part in ("program", "reference"):
        shutil.copy(bd / f"configs/tiny-rn.{part}.py", bd / f"configs/tiny-rn-new.{part}.py")
    # a traffic mix of an existing kind
    (bd / "traffic/tiny-sweep-new.json").write_text(json.dumps(
        {"kind": "sweep", "images": 24, "image_size": 64, "batch_size": 8, "num_samples": 3, "check_components": 4}))
    # a per-layer metric: its reader
    (bd / "metrics/sweeps_done.sweep.py").write_text(
        '"""Sweeps the window finished."""\n\n\ndef read(run):\n    return float(run.counters.get("sweeps", 0)) or None\n')
    shutil.copy(bd / "checks/tiny-rn.sweep.json", bd / "checks/tiny-rn-new.sweep.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-rn-new", "source": "x", "file": "portbench/configs/tiny-rn-new.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "tiny-rn-new.sweep", "config": "tiny-rn-new", "traffic": "tiny-sweep-new",
                              "chips": 1, "why": "x"})
    for m in spec["end_to_end"]:
        if "images_per_s" == m["name"]:
            m["workloads"].append("tiny-rn-new.sweep")
    spec["per_layer"].append({"name": "sweeps_done.sweep", "unit": "sweeps", "better": "higher",
                              "source": "program_counter", "layer": "orchestration", "moves": "images_per_s",
                              "workloads": ["tiny-rn-new.sweep"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    line, run = run_cell(root, "tiny-rn-new.sweep", trace=True)
    assert line["correct"] and line["metrics"]["sweeps_done.sweep"]["value"] == run.counters["sweeps"] >= 3
    assert run.traffic["images"] == 24 and run.config["name"] == "tiny-rn-new"
    line, _ = run_cell(root, "tiny-rn-new.sweep")
    assert set(line["metrics"]) == {"images_per_s", "setup_s"}
    after = _digests(root)
    assert all(after[p] == digest for p, digest in before.items())
