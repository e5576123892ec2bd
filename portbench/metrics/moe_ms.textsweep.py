"""Device milliseconds a batch of the MoE layers: per forward, the ``moe.route``, ``moe.experts`` and
``moe.combine`` spans of every MoE layer and the tap's ``moe.tap`` summed, each the median over the traced
pass's forwards."""

from portbench.harness import program_trace
from portbench.reference.deepseek_v2 import is_moe

PER_LAYER = ("moe.route", "moe.experts", "moe.combine")


def read(run):
    spans = (program_trace.snapshot(run) or {}).get("spans", {})
    cfg = run.config
    layers = sum(is_moe(cfg, i) for i in range(cfg["num_hidden_layers"]))
    parts = [program_trace.median_of_sums(spans[name]["recent_device_ms"], layers) if name in spans else None
             for name in PER_LAYER]
    if None in parts:
        return None
    tap = spans.get("moe.tap", {}).get("recent_device_ms")
    return sum(parts) + (program_trace.median_of_sums(tap, 1) if tap else 0.0)
