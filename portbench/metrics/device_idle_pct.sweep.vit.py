"""``device_idle_pct.sweep`` in the ViT sweep, where it moves ``images_per_s.vit``: the same reader."""


def read(run):
    return run.bench.reader("device_idle_pct.sweep").read(run)
