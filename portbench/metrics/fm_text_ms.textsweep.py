"""Device milliseconds a sweep of the FM's text tower: the ``embed.encode_text`` spans (one a batch of
strings) over the traced pass, divided by its sweeps (one ``collect.init`` each)."""

from portbench.harness import program_trace


def read(run):
    spans = (program_trace.snapshot(run) or {}).get("spans", {})
    text, sweeps = spans.get("embed.encode_text", {}), spans.get("collect.init", {}).get("calls")
    if not sweeps or not text.get("device_ms"):
        return None
    return text["device_ms"] / sweeps
