"""Median device milliseconds a batch of the subject's forward with its taps (the engine's ``collect.forward``
span; the one-sequence probe of each sweep is one call in 33 and the median keeps it out)."""

from portbench.harness import program_trace


def read(run):
    return program_trace.median_ms(run, "collect.forward", "device")
