"""``mfu_pct.sweep`` in the text sweep: the sequences of the unprofiled sweeps times the FLOPs of one (the
subject's whole forward over its tokens and the text tower over its string, ``configs/<config>.program.py``)
over those sweeps' seconds, at the card's bf16 dense peak. The same reader."""


def read(run):
    return run.bench.reader("mfu_pct.sweep").read(run)
