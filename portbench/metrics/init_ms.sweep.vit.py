"""``init_ms.sweep`` in the ViT sweep: the same reader."""


def read(run):
    return run.bench.reader("init_ms.sweep").read(run)
