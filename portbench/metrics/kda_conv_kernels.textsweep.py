"""The short-convolution kernel's share of the KDA layers: the program's counter ``kda.conv.kernel`` (one per launch
of the hand-written convolutions) over the traced pass's ``kda.attention`` calls; 1.0 when every KDA layer took the
kernel.

A program without the ``kda.short_conv`` span (one older than the kernel) reads nothing (no value).
"""

from portbench.harness import program_trace


def read(run):
    snap = program_trace.snapshot(run) or {}
    spans = snap.get("spans", {})
    calls = spans.get("kda.attention", {}).get("calls")
    if not calls or "kda.short_conv" not in spans:
        return None
    return snap["counters"].get("kda.conv.kernel", 0) / calls
