"""The search's least time on the card over the device time of one call, in %.

Least time (``harness/flops.search_least_s``): the larger of 2·Q·N·D at
the TF32 dense peak and the bank, the queries and the (Q, k) results once
at the HBM rate. Device time: the union of the call's kernel intervals,
averaged over the profiled calls.
"""

from portbench.harness import flops


def read(run):
    calls = run.counters.get("profiled_call_windows")
    if not calls or run.slice is None or run.device.type != "cuda":
        return None
    trace = run.slice[0]
    device_s = sum(trace.busy_s(lo, hi) for lo, hi in calls) / len(calls)
    if device_s <= 0:
        return None
    least_s, _ = flops.search_least_s(*run.counters["search_shape"], flops.peaks(run.card))
    return 100.0 * least_s / device_s
