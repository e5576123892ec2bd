"""The readings behind the correctness limits: the numbers a cell compares, for many seeds, in one process.

    python3 portbench/tools/readings.py --workload <name> --seeds 11 12 13 [--control | --fault <fault>]

Each seed runs the cell's set-up and one unit of its timed path (one sweep,
one search call) at the cell's own sizes, without warm-up or window, then
its check over every number its kind can compute (``NUMBERS``), and prints
one JSON line ``{"seed", "variant", "numbers", "correct"}``, ``correct``
judged by the cell's limits as a run judges it. ``--control`` runs the
configuration's control instead of the program (the program's own
lower-precision path, or the reference in its place); ``--fault`` plants
one fault of ``harness/faults.py`` in the program. The largest program
reading over a dozen seeds and the smallest control reading are the two
ends a limit is set between.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import device as dev  # noqa: E402

dev.set_cache_dirs(ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault")
    args = parser.parse_args(argv)

    import torch

    from portbench.harness import checks
    from portbench.harness.bench import Benchmark
    from portbench.harness.faults import planted
    from portbench.harness.runner import Run

    bench = Benchmark(ROOT)
    device = dev.require_cards(bench.workload(args.workload)["chips"])
    variant = "control" if args.control else "program"
    limits = bench.limits(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = Run(bench, args.workload, seed=seed, seconds=0, trace=False, device=device, variant=variant,
                  warmup=False)
        with planted(args.fault) if args.fault else contextlib.nullcontext():
            run.kind.setup(run)
            run.kind.window(run)
        run.kind.release(run)
        numbers = run.kind.check(run, run.kind.NUMBERS)
        correct, _ = checks.judge(numbers, limits)
        print(json.dumps({"workload": args.workload, "seed": seed, "variant": args.fault or variant,
                          "numbers": numbers, "correct": correct, "seconds": time.perf_counter() - t0,
                          "card": run.card}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
