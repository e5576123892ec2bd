"""Run one benchmark cell once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout with one CUDA card per chip the cell asks for.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (and the device's busy and window seconds and a
breakdown). The last line of standard output is the result's JSON; the
numbers the correctness check compared, each beside its limit, are the
last lines of standard error. Exit codes: 0 with a result, 2 without the
cards the cell asks for, 3 when a forbidden module (the JAX stack or the
JAX package) was loaded, 1 on any other failure.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.harness import device as dev  # noqa: E402

dev.set_cache_dirs(ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench.harness.bench import Benchmark
    from portbench.harness.runner import Run, emit, execute

    bench = Benchmark(ROOT)
    chips = bench.workload(args.workload)["chips"]
    try:
        device = dev.require_cards(chips)
    except dev.NoCard as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(min(4, torch.get_num_threads()))
    run = Run(bench, args.workload, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=device)
    line, report = execute(run, STARTED)
    found = dev.forbidden_loaded()
    if found:
        print(f"portbench: forbidden modules loaded in the measured process: {', '.join(found)}", file=sys.stderr)
        return 3
    emit(line, report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
