"""Device milliseconds per batch of the image tower's encode, by CUDA events around it."""


def read(run):
    ms = run.spans.device_ms().get("fm_image")
    return sum(ms) / len(ms) if ms else None
