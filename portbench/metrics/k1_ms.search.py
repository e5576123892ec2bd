"""Device milliseconds of the ``search.k1`` spans a search call: the median over the recent calls.

Span time, not kernel time: the CUDA events sit around ``_cosine_matrix``,
so besides K1's kernels the span holds the card's idle while the host
plans and enqueues the launch (the previous chunk's tie test has emptied
the stream). K1's kernel time alone is ``cosine_tiled_kernel`` in the
profiled slice's breakdown.
"""

from portbench.harness import program_trace


def read(run):
    return program_trace.median_per_search_call(run, "search.k1", "device")
