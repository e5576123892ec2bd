"""Device milliseconds of one call: the union of its kernels' intervals, averaged over the profiled calls."""


def read(run):
    calls = run.counters.get("profiled_call_windows")
    if not calls or run.slice is None:
        return None
    trace = run.slice[0]
    return 1e3 * sum(trace.busy_s(lo, hi) for lo, hi in calls) / len(calls)
