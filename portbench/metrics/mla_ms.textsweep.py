"""Device milliseconds a batch of latent attention: the ``mla.attention`` spans of one forward (every layer)
summed, the median over the traced pass's forwards."""

from portbench.harness import program_trace


def read(run):
    spans = (program_trace.snapshot(run) or {}).get("spans", {})
    values = spans.get("mla.attention", {}).get("recent_device_ms")
    return program_trace.median_of_sums(values, run.config["num_hidden_layers"]) if values else None
