"""Host milliseconds per sweep from the fused pass's return to ``compute_concept_db``'s: the concept DB's gather."""


def read(run):
    ms = run.spans.host.get("orchestration")
    return sum(ms) / len(ms) if ms else None
