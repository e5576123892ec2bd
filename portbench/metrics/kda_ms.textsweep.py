"""Device milliseconds a batch of Kimi Delta Attention: the ``kda.attention`` spans of one forward (every KDA
layer, projections, convolutions, gates, norms and the recurrence) summed, the median over the traced pass's
forwards.

A program without that span (one older than the KDA layer) reads nothing (no value).
"""

from portbench.harness import program_trace


def kda_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"] - len(cfg["linear_attn_config"]["full_attn_layers"])


def read(run):
    spans = (program_trace.snapshot(run) or {}).get("spans", {})
    values = spans.get("kda.attention", {}).get("recent_device_ms")
    return program_trace.median_of_sums(values, kda_layers(run.config)) if values else None
