"""``upload_host_ms.sweep`` in the ViT sweep: the same reader."""


def read(run):
    return run.bench.reader("upload_host_ms.sweep").read(run)
