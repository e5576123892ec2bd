"""``topk_ms.sweep`` in the ViT sweep: the same reader."""


def read(run):
    return run.bench.reader("topk_ms.sweep").read(run)
