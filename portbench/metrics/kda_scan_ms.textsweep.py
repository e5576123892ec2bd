"""Device milliseconds a batch of the KDA recurrence alone: the ``kda.recurrence`` spans of one forward (one
kernel launch each, inside its layer's ``kda.attention``) summed, the median over the traced pass's forwards.

A program without that span reads nothing (no value).
"""

from portbench.harness import program_trace


def read(run):
    spans = (program_trace.snapshot(run) or {}).get("spans", {})
    values = spans.get("kda.recurrence", {}).get("recent_device_ms")
    if not values:
        return None
    return program_trace.median_of_sums(values, run.bench.reader("kda_ms.textsweep").kda_layers(run.config))
