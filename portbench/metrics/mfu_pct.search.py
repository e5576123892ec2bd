"""Share of the card's TF32 dense peak that the searches' dots make up over the calls' wall time.

2·Q·N·D per call, over the host-clock latencies of the window's unprofiled
calls (each from the call to its results on the host) and the data-sheet
TF32 peak of the card the run names (the fastest rate on float32
operands). It bounds ``search_roofline_pct.search`` from below.
"""

from portbench.harness import flops


def read(run):
    c = run.counters
    if not c.get("unprofiled_call_s") or run.device.type != "cuda":
        return None
    q, n, d, _ = c["search_shape"]
    return 100.0 * c["unprofiled_calls"] * 2.0 * q * n * d / (c["unprofiled_call_s"] * flops.peaks(run.card)["tf32"])
