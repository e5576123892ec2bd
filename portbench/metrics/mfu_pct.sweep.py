"""Share of the card's bf16 dense peak that the sweeps' model FLOPs make up.

The images of the window's unprofiled sweeps times the FLOPs of one image
(subject and image tower, the frozen counters of ``harness/flops.py``)
over those sweeps' seconds and the data-sheet peak of the card the run
names. An unknown card has no peak, and the run fails.
"""

from portbench.harness import flops


def read(run):
    c = run.counters
    if not c.get("plain_sweeps_s") or run.device.type != "cuda":
        return None
    return 100.0 * c["images"] * c["flops_per_image"] / (c["plain_sweeps_s"] * flops.peaks(run.card)["bf16"])
