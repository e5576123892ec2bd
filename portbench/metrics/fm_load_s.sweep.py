"""Host seconds of the image tower's weight placement in set-up (``fm.load``: state dict to the card's tensors)."""

from portbench.harness import program_trace


def read(run):
    snap = program_trace.setup_snapshot(run)
    load = (snap or {}).get("spans", {}).get("fm.load")
    return load["host_ms"] / 1e3 if load else None
