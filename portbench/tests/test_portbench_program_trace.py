"""The readers of the program's own tracer: per-call medians that keep the warm-up's first calls out."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.harness import program_trace
from portbench.harness.bench import load_module

METRICS = Path(__file__).resolve().parents[1] / "metrics"


@pytest.mark.parametrize("values,n,want", [
    ([5.0, 1.0, 2.0, 3.0, 4.0], 2, 5.0),  # (3+4), (1+2): the partial first run is dropped
    ([9.0, 1.0, 1.0, 1.0], 1, 1.0),
    ([1.0, 2.0], 3, None),
    ([1.0, 2.0], 0, None),
])
def test_median_of_sums_counts_back_from_the_last_call(values, n, want):
    assert program_trace.median_of_sums(values, n) == want


def test_search_readers_keep_the_first_calls_build_out(monkeypatch):
    chunks, calls = 4, 5
    k1 = [30_000.0] + [2.0] * (chunks * calls - 1)  # the first K1 span waits for the kernel's build
    snap = {"spans": {"search.call": {"calls": calls},
                      "search.k1": {"calls": chunks * calls, "recent_device_ms": k1},
                      "search.prepare": {"calls": calls, "recent_host_ms": [40.0, 0.1, 0.1, 0.2, 0.1]}},
            "counters": {"k1.launches.tiled": chunks * calls}}
    monkeypatch.setattr(program_trace, "snapshot", lambda run: snap)
    run = SimpleNamespace()
    read = {name: load_module(METRICS / f"{name}.search.py", name).read
            for name in ("k1_ms", "merge_ms", "prepare_ms", "k1_launches")}
    assert read["k1_ms"](run) == chunks * 2.0
    assert read["prepare_ms"](run) == 0.1
    assert read["k1_launches"](run) == chunks
    assert read["merge_ms"](run) is None  # no such span recorded


def _fake_run(device_type: str):
    return SimpleNamespace(bench=None, name="cell", seed=2147483701, device=SimpleNamespace(type=device_type),
                           state={})


def test_the_traced_pass_is_made_once_with_the_tracer_on_and_leaves_it_as_found(monkeypatch):
    import torch

    from portbench.harness import runner
    from semanticlens_tpu_torch.utils import profiling

    seen = []

    class Kind:
        def setup(self, unit):
            with profiling.span("fm.load"):
                seen.append(("setup", profiling.enabled()))

        def window(self, unit):
            with profiling.span("search.call"):
                seen.append(("window", profiling.enabled()))

        def release(self, unit):
            seen.append(("release", profiling.enabled()))

    class Unit:  # the cell's second instance: its own state, untraced by the harness, PASS_SECONDS of traffic
        def __init__(self, bench, name, *, seed, seconds, trace, device):
            assert (name, seconds, trace) == ("cell", program_trace.PASS_SECONDS, False)
            self.kind, self.state = Kind(), {}

    monkeypatch.setattr(runner, "Run", Unit)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    was = profiling.enabled()
    profiling.enable(False)
    try:
        run = _fake_run("cuda")
        made = program_trace.traced_pass(run)
        assert program_trace.traced_pass(run) is made and seen[:2] == [("setup", True), ("window", True)]
        assert len(seen) == 3 and seen[2][0] == "release"
        assert set(program_trace.setup_snapshot(run)["spans"]) == {"fm.load"}
        assert set(program_trace.snapshot(run)["spans"]) == {"search.call"}
        assert not profiling.enabled() and profiling.snapshot() == {"spans": {}, "counters": {}}
    finally:
        profiling.enable(was)


@pytest.mark.parametrize("device_type,has_tracer", [("cpu", True), ("cuda", False)])
def test_no_pass_on_the_cpu_or_for_a_program_without_the_tracer(monkeypatch, device_type, has_tracer):
    def refuse(run, tracer):
        raise AssertionError("a pass was made")

    monkeypatch.setattr(program_trace, "_pass", refuse)
    if not has_tracer:
        monkeypatch.setattr(program_trace, "_tracer", lambda: None)
    run = _fake_run(device_type)
    assert program_trace.snapshot(run) is program_trace.setup_snapshot(run) is None
    read = load_module(METRICS / "fm_load_s.sweep.py", "fm_load_s").read
    assert read(run) is None and program_trace.median_ms(run, "collect.topk", "device") is None
