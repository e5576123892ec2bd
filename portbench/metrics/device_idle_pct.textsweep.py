"""``device_idle_pct.sweep`` in the text sweep: the share of the profiled sweep's wall time with no kernel,
copy or memset on the card. The same reader."""


def read(run):
    return run.bench.reader("device_idle_pct.sweep").read(run)
