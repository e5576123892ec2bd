"""Device milliseconds per batch of the subject's ``apply`` (forward and taps), by CUDA events around it."""


def read(run):
    ms = run.spans.device_ms().get("subject")
    return sum(ms) / len(ms) if ms else None
