"""Device milliseconds a batch of KDA's short convolutions: the ``kda.short_conv`` spans of one forward (one kernel
launch each, inside its layer's ``kda.attention``: q, k and v made from their projections, normed) summed, the
median over the traced pass's forwards.

A program without that span (one older than the convolutions' kernel) reads nothing (no value).
"""

from portbench.harness import program_trace


def read(run):
    spans = (program_trace.snapshot(run) or {}).get("spans", {})
    values = spans.get("kda.short_conv", {}).get("recent_device_ms")
    if not values:
        return None
    return program_trace.median_of_sums(values, run.bench.reader("kda_ms.textsweep").kda_layers(run.config))
