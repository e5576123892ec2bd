"""The routed experts' least time on the card over their device time, in %.

Least time: the larger of 2·3·H·I FLOPs per routed pair (the program's
counter ``moe.routed_pairs``) at the card's bf16 dense peak, and the bytes
of every expert's matrices read once a layer call plus each pair's input
and output rows at the HBM rate (``configs/<config>.program.py``). Device
time: the ``moe.experts`` spans (the grouped GEMMs and the activation
between them), all over the traced pass.
"""

from portbench.harness import flops, program_trace


def read(run):
    snap = program_trace.snapshot(run)
    span = (snap or {}).get("spans", {}).get("moe.experts", {})
    pairs = (snap or {}).get("counters", {}).get("moe.routed_pairs")
    if not pairs or not span.get("device_ms"):
        return None
    card, cfg = flops.peaks(run.card), run.config
    least_s = max(pairs * run.program.expert_flops_per_pair(cfg) / card["bf16"],
                  run.program.expert_bytes(cfg, pairs, span["calls"]) / card["hbm_bytes_per_s"])
    return 100.0 * least_s / (span["device_ms"] / 1e3)
