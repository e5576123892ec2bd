"""Shared fixtures of the benchmark's own tests: a benchmark root with cut-down cells that run on the CPU.

``tiny_root`` copies ``portbench/`` and ``BENCHMARK.json`` into a temporary
directory and adds, as new files and entries only, three cells of tiny
configurations in float32 (a ResNet-50 at 64×64 with a two-block CLIP
tower, a two-block ViT with a two-block SigLIP tower, and a 5,000-row
search), each held to its full-size counterpart's limits.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CLIP = {"embed_dim": 32, "vision": {"image_size": 64, "patch_size": 16, "width": 64, "layers": 2, "heads": 2},
             "text": {"context_length": 16, "vocab_size": 1000, "width": 32, "heads": 2, "layers": 1}}
TINY_SIGLIP = {"embed_dim": 64, "vision": {"image_size": 64, "patch_size": 16, "width": 64, "layers": 2, "heads": 2},
               "text": {"context_length": 16, "vocab_size": 1000, "width": 64, "heads": 2, "layers": 1}}


def _tiny_configs(bench_dir: Path) -> dict:
    rn = json.loads((bench_dir / "configs/rn50-clip-b32.json").read_text())
    rn.update(name="tiny-rn", dtype="float32")
    rn["subject"]["image_size"] = 64
    rn["subject_preprocess"].update(size=64, crop=64)
    rn["fm"].update(TINY_CLIP)
    rn["fm_preprocess"].update(size=64, crop=64)
    vit = json.loads((bench_dir / "configs/vitb16-siglip2.json").read_text())
    vit.update(name="tiny-vit", dtype="float32", components={"blocks.1.mlp.fc1": 256, "blocks.1.attn.heads": 2})
    vit["subject"].update(image_size=64, width=64, depth=2, heads=2, num_classes=10)
    vit["subject_preprocess"].update(size=64, crop=64)
    vit["fm"].update(TINY_SIGLIP)
    vit["fm_preprocess"].update(size=64, crop=64)
    return {"tiny-rn": (rn, "rn50-clip-b32"), "tiny-vit": (vit, "vitb16-siglip2")}


def make_tiny_root(dest: Path) -> Path:
    """A benchmark root at ``dest`` with the committed files and the tiny cells added."""
    shutil.copytree(ROOT / "portbench", dest / "portbench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bd = dest / "portbench"
    for name, (cfg, full) in _tiny_configs(bd).items():
        (bd / f"configs/{name}.json").write_text(json.dumps(cfg))
        for part in ("program", "reference"):
            shutil.copy(bd / f"configs/{full}.{part}.py", bd / f"configs/{name}.{part}.py")
        bench["configs"].append({"name": name, "source": "a cut-down copy for tests", "reduced": [],
                                 "file": f"portbench/configs/{name}.json", "why": "tests on the CPU"})
    (bd / "traffic/tiny-sweep-72.json").write_text(json.dumps(
        {"kind": "sweep", "images": 40, "image_size": 72, "batch_size": 16, "num_samples": 5, "check_components": 8}))
    (bd / "traffic/tiny-sweep-64.json").write_text(json.dumps(
        {"kind": "sweep", "images": 40, "image_size": 64, "batch_size": 16, "num_samples": 5, "check_components": 8}))
    (bd / "traffic/tiny-search.json").write_text(json.dumps(
        {"kind": "search", "components": 5000, "queries": 16, "k": 8, "warmup_calls": 1, "profiled_calls": 2,
         "check_calls": 3}))
    cells = {"tiny-rn.sweep": ("tiny-rn", "tiny-sweep-72", "rn50-clip-b32.sweep"),
             "tiny-vit.sweep": ("tiny-vit", "tiny-sweep-64", "vitb16-siglip2.sweep"),
             "tiny-rn.search": ("tiny-rn", "tiny-search", "rn50-clip-b32.search")}
    for name, (config, traffic, full) in cells.items():
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "tests"})
        shutil.copy(bd / f"checks/{full}.json", bd / f"checks/{name}.json")
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if full in metric.get("workloads", []):
                metric["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("bench"))


def run_cell(root: Path, workload: str, *, trace: bool = False, seed: int = 2**31 + 17, seconds: float = 0.0):
    """One run of ``workload`` under ``root`` on the CPU: (result line, Run)."""
    import time

    import torch

    from portbench.harness.bench import Benchmark
    from portbench.harness.runner import Run, execute

    run = Run(Benchmark(root), workload, seed=seed, seconds=seconds, trace=trace, device=torch.device("cpu"))
    line, _ = execute(run, time.perf_counter())
    return line, run
