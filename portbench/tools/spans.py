"""The program's own spans in one cell: a traced run beside the outside metrics, and the idle gaps by span.

    python3 portbench/tools/spans.py --workload <name> --seed 2147483701 --seconds 20 [--out <file>.json]

1. With the program's tracer on (``semanticlens_tpu_torch.utils.profiling``),
   one sweep or search call after the cell's set-up, under the program's
   ``device_trace``: the longest idle gaps of the card, each with the
   program span the host was in (the innermost ``semanticlens.*``
   annotation under way) and the idle milliseconds that fall in each span;
2. then, with the tracer off again, a whole ``--trace 1`` run of the cell
   (what ``portbench/run.py`` prints, its readers' traced pass included),
   and the inside spans of that pass set against the outside metrics they
   are to replace.

One JSON document goes to standard output and to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import device as dev  # noqa: E402

dev.set_cache_dirs(ROOT)

TOP = 5
PREFIX = "semanticlens."


def innermost(spans: list[tuple[float, float, str]], t: float) -> str:
    """The name of the latest-starting span under way at ``t`` (``"outside"`` when none is)."""
    best = None
    for s, e, n in spans:
        if s <= t < e and (best is None or s >= best[0]):
            best = (s, n)
    return best[1] if best else "outside"


def idle_by_span(gaps, spans) -> dict[str, float]:
    """Idle milliseconds of ``gaps`` split at the span boundaries, each piece put down to its innermost span."""
    out: dict[str, float] = {}
    for lo, hi in gaps:
        cuts = sorted({lo, hi} | {t for s, e, _ in spans for t in (s, e) if lo < t < hi})
        for a, b in zip(cuts, cuts[1:]):
            name = innermost(spans, (a + b) / 2)
            out[name] = out.get(name, 0.0) + 1e3 * (b - a)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def gap_report(events: list[dict], window: str) -> dict:
    """The idle gaps of the card inside the annotation ``window``, labelled by the program's spans."""
    from portbench.harness.trace import parse

    trace = parse(events)
    spans = sorted((float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"])) * 1e-6, e["name"][len(PREFIX):])
                   for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith(PREFIX))
    (lo, hi), = trace.windows(window)
    gaps = trace.gaps(lo, hi)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {"window_ms": 1e3 * (hi - lo), "busy_ms": 1e3 * trace.busy_s(lo, hi),
            "longest_gaps": [{"start_ms": 1e3 * (a - lo), "ms": 1e3 * (b - a), "span": innermost(spans, a),
                              "spans": idle_by_span([(a, b)], spans)} for a, b in longest],
            "idle_ms_by_span": idle_by_span(gaps, spans)}


def traced_unit(run) -> dict:
    """One sweep or one search call under ``device_trace``, after the cell's set-up with the tracer on."""
    import torch

    from semanticlens_tpu_torch.utils import device_trace

    tmp = Path(tempfile.mkdtemp(prefix="portbench-spans-"))
    try:
        with device_trace(str(tmp)):
            with torch.profiler.record_function("portbench.unit"):
                run.kind.window(run)  # a window of 0 s: one sweep or one call
            torch.cuda.synchronize(run.device)
        with open(tmp / "trace.json") as f:
            return gap_report(json.load(f)["traceEvents"], "portbench.unit")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _median(snap, name, clock):
    values = snap["spans"].get(name, {}).get(f"recent_{clock}_ms")
    return statistics.median(values) if values else None


def inside_vs_outside(line: dict, snap: dict, profiled_calls: int) -> dict:
    """Each inside span (medians per batch or sweep) beside the outside metric it is to become the source of."""
    outside = {name.split(".sweep")[0]: m["value"] for name, m in line["metrics"].items()}

    def med(*names, clock="device"):
        values = [_median(snap, name, clock) for name in names]
        return None if None in values else sum(values)

    tiled = sum(t for n, t in line.get("breakdown", {}).get("device_ops", []) if "cosine_tiled" in n)
    pairs = {
        "collect.forward / subject_ms": (med("collect.forward"), outside.get("subject_ms")),
        "embed.encode / fm_image_ms": (med("embed.encode"), outside.get("fm_image_ms")),
        "collect.preprocess + embed.preprocess / preprocess_ms":
            (med("collect.preprocess", "embed.preprocess"), outside.get("preprocess_ms")),
        "concept_db.ingest + concept_db.gather / orchestration_ms":
            (med("concept_db.ingest", "concept_db.gather", clock="host"), outside.get("orchestration_ms")),
        "k1_ms.search / cosine_tiled_kernel per profiled call":
            (outside.get("k1_ms.search"), 1e3 * tiled / profiled_calls if tiled else None),
    }
    return {label: {"inside": a, "outside": b, "ratio": a / b} for label, (a, b) in pairs.items() if a and b}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    import torch

    from portbench.harness import program_trace
    from portbench.harness.bench import Benchmark
    from portbench.harness.runner import Run, execute
    from semanticlens_tpu_torch.utils import profiling

    bench = Benchmark(ROOT)
    device = dev.require_cards(bench.workload(args.workload)["chips"])
    profiling.enable()
    unit = Run(bench, args.workload, seed=args.seed, seconds=0.0, trace=False, device=device)
    unit.kind.setup(unit)
    gaps = traced_unit(unit)
    unit.kind.release(unit)
    del unit
    torch.cuda.empty_cache()
    profiling.enable(False)
    profiling.reset()

    run = Run(bench, args.workload, seed=args.seed, seconds=args.seconds, trace=True, device=device)
    line, _ = execute(run, time.perf_counter())
    snap = program_trace.snapshot(run)
    doc = {"workload": args.workload, "seed": args.seed, "card": run.card, "power_limit_w": dev.power_limit_w(),
           "gaps": gaps, "inside_vs_outside": inside_vs_outside(line, snap, run.traffic.get("profiled_calls", 1)),
           "spans": {name: {k: v for k, v in s.items() if not k.startswith("recent_")}
                     for name, s in snap["spans"].items()},
           "counters": snap["counters"], "line": line}
    text = json.dumps(doc, indent=1)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
