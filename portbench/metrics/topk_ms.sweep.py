"""Median device milliseconds per batch of the top-k update (the engine's ``collect.topk`` span, every layer)."""

from portbench.harness import program_trace


def read(run):
    return program_trace.median_ms(run, "collect.topk", "device")
