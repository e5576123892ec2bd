"""Naming and preprocessing helpers (counterpart of ``semanticlens_tpu.utils.helper``).

Cache identity must be stable across processes and across the two packages,
so fallback names hash the object's ``repr`` with sha256, as the JAX package
and the reference implementation do.
"""

from __future__ import annotations

import hashlib
from typing import Sequence


def _string_hash(s: str) -> int:
    """Stable (process-independent) integer hash of a string."""
    return int(hashlib.sha256(s.encode()).hexdigest(), 16)


def get_fallback_name(obj) -> str:
    """Fallback cache name: ``<ClassName>-<sha256(repr)>``."""
    return obj.__class__.__name__ + "-" + str(_string_hash(str(obj)))


def make_preprocess_fn(
    size: int = 224,
    crop: int | None = None,
    mean: Sequence[float] = (0.485, 0.456, 0.406),
    std: Sequence[float] = (0.229, 0.224, 0.225),
    interpolation: str = "bicubic",
):
    """Device-side resize → center-crop → normalize from a torchvision-style config.

    The returned function maps a (B, H, W, C) batch on any device to the
    normalized (B, crop, crop, C) float32 batch on the same device.
    """
    from semanticlens_tpu_torch.ops.preprocess import preprocess_images

    crop_size = crop or size

    def preprocess(images):
        return preprocess_images(
            images, size=size, crop=crop_size, mean=tuple(mean), std=tuple(std),
            interpolation=interpolation,
        )

    return preprocess
