"""Median host milliseconds per sweep of the engine's start (``collect.init``: the one-image probe, the top-k state)."""

from portbench.harness import program_trace


def read(run):
    return program_trace.median_ms(run, "collect.init", "host")
