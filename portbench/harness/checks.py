"""Judging the numbers a run compares against their limits, and reporting both."""

from __future__ import annotations

import math
import sys


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers ``limits`` names: correct when each is
    finite and at most its limit. A limit without a number is a fault of the harness and raises.
    """
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"the check computed no {sorted(missing)}")
    report = {name: {"value": float(numbers[name]), "limit": float(limits[name])} for name in sorted(limits)}
    correct = all(math.isfinite(r["value"]) and r["value"] <= r["limit"] for r in report.values())
    return correct, report


def print_report(report: dict, stream=sys.stderr) -> None:
    """One line per number, ``name value <= limit``, as the last lines of standard error."""
    for name, r in report.items():
        ok = math.isfinite(r["value"]) and r["value"] <= r["limit"]
        print(f"check {name} {r['value']!r} {'<=' if ok else '>'} limit {r['limit']!r}", file=stream, flush=True)
