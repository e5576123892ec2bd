"""Device milliseconds of the ``search.merge`` spans a search call: the median over the recent calls.

Span time, not kernel time: the merge's kernels plus the card's idle inside
the span, which holds the host's wait in each chunk's tie test
(``search.tie_test``) and the enqueue of the kernels after it.
"""

from portbench.harness import program_trace


def read(run):
    return program_trace.median_per_search_call(run, "search.merge", "device")
