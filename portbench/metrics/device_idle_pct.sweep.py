"""Share of the profiled sweep's wall time in which no kernel, copy or memset ran on the card."""


def read(run):
    if run.slice is None:
        return None
    trace, lo, hi = run.slice
    return 100.0 * (1.0 - trace.busy_s(lo, hi) / (hi - lo))
