"""The program's own tracer (``semanticlens_tpu_torch.utils.profiling``), as the benchmark reads it.

The cell's own set-up and window run with the tracer as the program leaves
it (off), so a traced run's other metrics read what an untraced program
does. The ``program_span`` and ``program_counter`` readers come after the
window and the check; the first of them to ask makes one traced pass of the
cell (:func:`traced_pass`), which the others share: a second instance of
the cell with the tracer on, its set-up (the build, the weights' placement,
the warm-up) and ``PASS_SECONDS`` of its traffic, then freed. Its set-up
and its traffic are two snapshots, so the per-batch, per-sweep and
per-call readers see no warm-up; they still take medians, which keep a
stray first call (one that waits for a kernel's build) out.

A program without the tracer (an older checkout) gives nothing to read:
no pass is made and the readers report no value rather than fail. Numbers
come from the card only: on the CPU there is no pass either.
"""

from __future__ import annotations

import importlib
import statistics
import sys

PASS_SECONDS = 4.0  # the traced pass's traffic: three ResNet sweeps, two ViT sweeps, some 80 search calls


def _tracer():
    try:
        tracer = importlib.import_module("semanticlens_tpu_torch.utils.profiling")
    except ImportError:
        return None
    has_all = all(hasattr(tracer, f) for f in ("enable", "enabled", "reset", "snapshot"))
    return tracer if has_all else None


def traced_pass(run) -> dict | None:
    """``{"setup": snapshot, "window": snapshot}`` of the cell's traced pass, made once a run; None on the CPU
    or for a program without the tracer."""
    if "program_trace" not in run.state:
        tracer = _tracer()
        run.state["program_trace"] = None if tracer is None or run.device.type != "cuda" else _pass(run, tracer)
    return run.state["program_trace"]


def _pass(run, tracer) -> dict:
    import torch

    from portbench.harness.runner import Run

    print(f"portbench: a traced pass of the cell for the program's spans ({PASS_SECONDS} s)", file=sys.stderr,
          flush=True)
    unit = Run(run.bench, run.name, seed=run.seed, seconds=PASS_SECONDS, trace=False, device=run.device)
    was = tracer.enabled()
    tracer.reset()
    tracer.enable()
    try:
        unit.kind.setup(unit)
        setup = tracer.snapshot()
        tracer.reset()
        unit.kind.window(unit)
        window = tracer.snapshot()
    finally:
        tracer.enable(was)
        tracer.reset()
        unit.kind.release(unit)
        unit.state.clear()
        torch.cuda.empty_cache()
    return {"setup": setup, "window": window}


def snapshot(run) -> dict | None:
    """The tracer's spans and counters over the traced pass's traffic; None where there was no pass."""
    made = traced_pass(run)
    return made["window"] if made else None


def setup_snapshot(run) -> dict | None:
    """The tracer's spans and counters over the traced pass's set-up; None where there was no pass."""
    made = traced_pass(run)
    return made["setup"] if made else None


def median_ms(run, name: str, clock: str) -> float | None:
    """The median per-call milliseconds of span ``name`` on ``clock`` (``host`` or ``device``)."""
    spans = (snapshot(run) or {}).get("spans", {})
    values = spans.get(name, {}).get(f"recent_{clock}_ms")
    return statistics.median(values) if values else None


def median_per_search_call(run, name: str, clock: str) -> float | None:
    """The median over the recent search calls of span ``name``'s milliseconds a call on ``clock``.

    A span that opens n times a call (K1 and the merge: once a chunk) is summed over each call's n values.
    """
    spans = (snapshot(run) or {}).get("spans", {})
    calls = spans.get("search.call", {}).get("calls")
    span = spans.get(name, {})
    values = span.get(f"recent_{clock}_ms")
    if not calls or not values:
        return None
    return median_of_sums(values, span["calls"] // calls)


def median_of_sums(values, n: int) -> float | None:
    """The median of the sums of consecutive runs of ``n`` values counted back from the last (a partial first run dropped)."""
    if n < 1:
        return None
    sums = [sum(values[end - n:end]) for end in range(len(values), n - 1, -n)]
    return statistics.median(sums) if sums else None


def per_search_call(run, total) -> float | None:
    """``total(snapshot)`` divided by the recorded ``search.call`` calls (None where either is missing)."""
    snap = snapshot(run)
    calls = (snap or {}).get("spans", {}).get("search.call", {}).get("calls")
    if not calls:
        return None
    value = total(snap)
    return None if value is None else value / calls
