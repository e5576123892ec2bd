"""Host milliseconds a search call from its entry to the chunk loop (``search.prepare``): the median over the recent calls."""

from portbench.harness import program_trace


def read(run):
    return program_trace.median_per_search_call(run, "search.prepare", "host")
