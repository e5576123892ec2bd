"""The concept DB's gather in GB/s (1e9 B): the program's counter ``concept_db.bytes`` (every layer's gathered
DB, as returned) over the ``concept_db.gather`` span's host seconds, both totals over the traced pass's sweeps.

A program without that counter (one older than the one-pass gather) reads nothing (no value).
"""

from portbench.harness import program_trace


def read(run):
    snap = program_trace.snapshot(run) or {}
    moved = snap.get("counters", {}).get("concept_db.bytes")
    ms = snap.get("spans", {}).get("concept_db.gather", {}).get("host_ms")
    if not moved or not ms:
        return None
    return moved / (ms * 1e6)
