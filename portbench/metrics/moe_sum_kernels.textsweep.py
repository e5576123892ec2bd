"""The combine kernel's share of the MoE layers' combines: the program's counter ``moe.combine.kernel`` (one
per launch of the hand-written gather-sum) over the traced pass's ``moe.combine`` calls; 1.0 when every MoE
layer took the kernel.

A program without the ``moe.weighted_sum`` span (one older than the kernel) reads nothing (no value).
"""

from portbench.harness import program_trace


def read(run):
    snap = program_trace.snapshot(run) or {}
    spans = snap.get("spans", {})
    calls = spans.get("moe.combine", {}).get("calls")
    if not calls or "moe.weighted_sum" not in spans:
        return None
    return snap["counters"].get("moe.combine.kernel", 0) / calls
