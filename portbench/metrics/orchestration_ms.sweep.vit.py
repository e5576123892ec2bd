"""``orchestration_ms.sweep`` in the ViT sweep, where it moves ``images_per_s.vit``: the same reader."""


def read(run):
    return run.bench.reader("orchestration_ms.sweep").read(run)
