"""Device milliseconds a batch of the routed experts' weighted sums: per forward, the ``moe.weighted_sum``
spans of every MoE layer summed (each nested in its layer's ``moe.combine``), the median over the traced
pass's forwards.

A program without that span reads nothing (no value).
"""

from portbench.harness import program_trace
from portbench.reference.deepseek_v2 import is_moe


def read(run):
    spans = (program_trace.snapshot(run) or {}).get("spans", {})
    values = spans.get("moe.weighted_sum", {}).get("recent_device_ms")
    if not values:
        return None
    cfg = run.config
    return program_trace.median_of_sums(values, sum(is_moe(cfg, i) for i in range(cfg["num_hidden_layers"])))
