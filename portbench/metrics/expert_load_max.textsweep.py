"""The routing's unevenness: tokens on a layer's busiest expert over the mean, the median over the MoE layers
and full batches of the traced pass (the program's tallies ``moe.expert_load.<layer>``; the one-sequence
probes, with fewer routed pairs, are left out)."""

import statistics

from portbench.harness import program_trace


def read(run):
    tallies = (program_trace.snapshot(run) or {}).get("tallies", {})
    calls = [c for name, kept in tallies.items() if name.startswith("moe.expert_load.") for c in kept]
    if not calls:
        return None
    full = max(sum(c) for c in calls)
    return statistics.median(max(c) * len(c) / full for c in calls if sum(c) == full)
