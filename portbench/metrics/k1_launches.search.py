"""K1 launches per search call: the ``k1.launches.*`` counters over the recorded ``search.call`` calls."""

from portbench.harness import program_trace


def read(run):
    def launches(snap):
        counters = snap["counters"]
        return counters.get("k1.launches.tiled", 0) + counters.get("k1.launches.streaming", 0)

    return program_trace.per_search_call(run, launches)
