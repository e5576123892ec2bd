"""Median host milliseconds per batch of the upload's enqueue (``collect.upload``: pinning and the side-stream copy)."""

from portbench.harness import program_trace


def read(run):
    return program_trace.median_ms(run, "collect.upload", "host")
