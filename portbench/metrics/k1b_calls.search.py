"""K1b launches per search call: the program's counter ``search.k1b`` (one per call that took K1b, the
tiled K1 with the top-k in its epilogue) over the recorded ``search.call`` calls.

A program without that counter reads nothing (no value), as does one whose calls all took the chunked path.
"""

from portbench.harness import program_trace


def read(run):
    return program_trace.per_search_call(run, lambda snap: snap["counters"].get("search.k1b"))
