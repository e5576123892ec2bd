"""One run of one cell: set-up, the measured window, the check, and the result line.

``execute`` drives the cell's traffic kind (``kinds/<kind>.py``), which
provides ``setup(run)``, ``window(run)``, ``release(run)``, ``NUMBERS`` and
``check(run, names) -> {number: value}`` (the numbers named by the cell's
``checks/<cell>.json`` and no others), and fills the :class:`Run` it is given:
``e2e`` (end-to-end values), ``spans``, ``counters``, ``traces`` and
``slice`` (the profiled part of the window), ``attempted`` and ``failed``.
The per-layer readers (``metrics/<name>.py``, ``read(run) -> float |
None``) turn those into the traced run's metrics.
"""

from __future__ import annotations

import json
import sys
import time

from portbench.harness import checks, device as dev
from portbench.harness.bench import Benchmark
from portbench.harness.spans import Spans


class Run:
    """The state of one run, shared by the harness, the cell's traffic kind and the metric readers."""

    def __init__(self, bench: Benchmark, workload: str, *, seed: int, seconds: float, trace: bool, device,
                 variant: str = "program", warmup: bool = True):
        self.bench = bench
        self.name = workload
        self.workload = bench.workload(workload)
        self.config = bench.config(self.workload["config"])
        self.traffic = bench.traffic(self.workload["traffic"])
        self.kind = bench.kind(self.traffic["kind"])
        self.program = bench.config_module(self.workload["config"], "program")
        self.reference = bench.config_module(self.workload["config"], "reference")
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.variant, self.warmup = device, variant, warmup
        self.card = dev.describe(device, self.workload["chips"], 0)["kind"]
        self.state: dict = {}
        self.e2e: dict[str, float] = {}
        self.spans = Spans(device)
        self.counters: dict = {}
        self.traces: list = []
        self.slice = None  # (Trace, lo, hi): the profiled part of the window
        self.attempted = 0
        self.failed = 0
        self.setup_s = None


def execute(run: Run, started: float) -> tuple[dict, dict]:
    """Run the cell once; returns (the result line, the check's report).

    ``started`` is the ``time.perf_counter()`` of the process start: set-up
    is everything from it to the window's start.
    """
    kind = run.kind
    kind.setup(run)
    run.setup_s = time.perf_counter() - started
    on_card = run.device.type == "cuda"
    if on_card:
        print(f"card before the window: {dev.clocks()}", file=sys.stderr, flush=True)
    kind.window(run)
    if on_card:
        print(f"card after the window: {dev.clocks()}", file=sys.stderr, flush=True)
    peak = dev.memory_peak_bytes(run.device)
    kind.release(run)
    limits = run.bench.limits(run.name)
    correct, report = checks.judge(kind.check(run, sorted(limits)), limits)
    if not correct:
        run.failed = max(run.failed, 1)
    device = dev.describe(run.device, run.workload["chips"], peak)
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed}
    if run.trace:
        line["metrics"] = per_layer(run)
        if run.slice is not None:
            trace, lo, hi = run.slice
            device.update(busy_s=trace.busy_s(lo, hi), window_s=hi - lo)
            line["device"] = device
            line["breakdown"] = trace.breakdown(lo, hi)
        else:
            line["device"] = device
    else:
        line["metrics"] = end_to_end(run)
        line["device"] = device
    line["checks"] = report
    return line, report


def end_to_end(run: Run) -> dict:
    """The cell's end-to-end metrics. A name ``<quantity>.<group>`` reports the kind's ``<quantity>``: one
    quantity bounded apart in the group of cells the metric lists (``images_per_s.vit``)."""
    out = {}
    for m in run.bench.metrics_of(run.name, "end_to_end"):
        quantity = m["name"].split(".")[0]
        value = run.setup_s if quantity == "setup_s" else run.e2e.get(quantity)
        if value is None:
            raise KeyError(f"{run.name} reports no {m['name']}, which BENCHMARK.json lists for it")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def per_layer(run: Run) -> dict:
    out = {}
    for m in run.bench.metrics_of(run.name, "per_layer"):
        value = run.bench.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def emit(line: dict, report: dict) -> None:
    """The result: the checked numbers as the last lines of standard error, the JSON line last on standard out."""
    print(json.dumps(line), flush=True)
    checks.print_report(report)
    sys.stderr.flush()
