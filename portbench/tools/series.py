"""Run one cell several times, one process per run, and summarize its spread.

    python3 portbench/tools/series.py --workload <name> --seeds 1 2 3 4 5 6 --seconds 20 --trace 0 \
        [--out chiprun_out/<file>.jsonl]

Each run is ``python3 portbench/run.py`` with the next seed, one after the
other. Every result line (or the failure's exit code and standard error's
end) goes to ``--out``; the summary printed last gives, per metric, the
median and the spread (distance between the first and third quartile of
``statistics.quantiles(values, n=4)``, as a share of the median), with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    from portbench.harness.device import power_limit_w

    lines = []
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            cmd = [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", args.workload, "--seed",
                   str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=1500)
            record = {"workload": args.workload, "seed": seed, "trace": args.trace, "rc": proc.returncode}
            if proc.returncode == 0:
                record["result"] = json.loads(proc.stdout.strip().splitlines()[-1])
                lines.append(record["result"])
            record["stderr_tail"] = proc.stderr[-3000:]
            print(json.dumps(record), flush=True)
            if sink:
                sink.write(json.dumps(record) + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    summary = {"workload": args.workload, "runs": len(args.seeds), "ok": len(lines),
               "correct": sum(1 for r in lines if r["correct"]), "power_limit_w": power_limit_w(),
               "card": lines[0]["device"]["kind"] if lines else None, "metrics": {}}
    for name in sorted({m for r in lines for m in r["metrics"]}):
        values = [r["metrics"][name]["value"] for r in lines if name in r["metrics"]]
        summary["metrics"][name] = {"median": statistics.median(values), "spread": spread(values), "values": values}
    print("SUMMARY " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
