"""``BENCHMARK.json`` and the files it names: everything is found by name, nothing is listed in code.

Under the benchmark's folder (``portbench/``, below the checkout root):

- ``configs/<config>.json``: a configuration's sizes (the file that
  ``BENCHMARK.json`` names); beside it ``configs/<config>.program.py``,
  which builds the program's objects from it, and
  ``configs/<config>.reference.py``, its plain reference;
- ``traffic/<traffic>.json``: a traffic mix, whose ``kind`` names its
  driver, ``kinds/<kind>.py``;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``checks/<workload>.json``: the limits of the numbers a cell compares.

A later cell, mix or metric adds files and ``BENCHMARK.json`` entries; no
file here lists them.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = "portbench"


def checkout_root() -> Path:
    """The checkout this file lies in (two levels above ``portbench/harness``)."""
    return Path(__file__).resolve().parents[2]


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, label: str):
    """Import the Python file ``path`` as a module named ``label`` and a digest of the path (file names may
    hold ``-`` and ``.``); a file is imported once per process."""
    label = f"{label}_{hashlib.sha256(str(Path(path).resolve()).encode()).hexdigest()[:12]}"
    if label in sys.modules:
        return sys.modules[label]
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[label] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[label]
        raise
    return module


class Benchmark:
    """``BENCHMARK.json`` at ``root`` and lookups of its entries and their files by name."""

    def __init__(self, root: Path | None = None):
        self.root = Path(root) if root is not None else checkout_root()
        self.dir = self.root / BENCH_DIR
        self.spec = load_json(self.root / "BENCHMARK.json")

    def _named(self, key: str, name: str) -> dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config_entry(self, name: str) -> dict:
        return self._named("configs", name)

    def config(self, name: str) -> dict:
        """The configuration's file, as run."""
        return load_json(self.root / self.config_entry(name)["file"])

    def config_module(self, name: str, part: str):
        """``configs/<config>.<part>.py`` beside the configuration's file (``program`` or ``reference``)."""
        path = (self.root / self.config_entry(name)["file"]).with_suffix(f".{part}.py")
        return load_module(path, f"portbench_config_{name}_{part}".replace("-", "_").replace(".", "_"))

    def traffic(self, name: str) -> dict:
        return load_json(self.dir / "traffic" / f"{name}.json")

    def kind(self, kind: str):
        return load_module(self.dir / "kinds" / f"{kind}.py", f"portbench_kind_{kind}")

    def limits(self, workload: str) -> dict:
        return load_json(self.dir / "checks" / f"{workload}.json")

    def reader(self, metric: str):
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))

    def metrics_of(self, workload: str, section: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries that apply to ``workload``."""
        return [m for m in self.spec[section] if workload in m.get("workloads", [workload])]
