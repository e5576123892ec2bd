"""The KDA recurrence's least time on the card over its device time, in %.

Least time: the larger of 7·d² operations per token-head at the card's bf16
dense peak and 2·(5·d + 1) bytes per token-head (q, k, v, g and o as bf16
elements, β) at the HBM rate (``configs/<config>.program.py``), over the
program's counter ``kda.token_heads`` (B·T·h a layer call). This counts the
work the layer must do whatever computes it. Device time: the
``kda.recurrence`` spans, all over the traced pass.

A program without that span or counter reads nothing (no value).
"""

from portbench.harness import flops, program_trace


def read(run):
    snap = program_trace.snapshot(run)
    span = (snap or {}).get("spans", {}).get("kda.recurrence", {})
    token_heads = (snap or {}).get("counters", {}).get("kda.token_heads")
    if not token_heads or not span.get("device_ms"):
        return None
    card, cfg = flops.peaks(run.card), run.config
    least_s = token_heads * max(run.program.kda_flops_per_token_head(cfg) / card["bf16"],
                                run.program.kda_bytes_per_token_head(cfg) / card["hbm_bytes_per_s"])
    return 100.0 * least_s / (span["device_ms"] / 1e3)
