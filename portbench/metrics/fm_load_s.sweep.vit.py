"""``fm_load_s.sweep`` in the ViT sweep: the same reader."""


def read(run):
    return run.bench.reader("fm_load_s.sweep").read(run)
