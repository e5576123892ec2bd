"""Naming, preprocessing and denormalization helpers (counterpart of ``semanticlens_tpu.utils.helper``).

Cache identity must be stable across processes and across the two packages,
so fallback names hash the object's ``repr`` with sha256, as the JAX package
and the reference implementation do.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np
import torch


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


def to_transforms_compose(instance):
    """A torchvision ``ImageClassification`` preset as the port's device-side preprocess fn.

    Counterpart of the JAX package's ``to_transforms_compose`` (reference
    semanticlens/utils/helper.py:21-35): reads ``resize_size`` /
    ``crop_size`` / ``mean`` / ``std`` / ``interpolation`` off any object
    that has them (torchvision need not be installed) and returns
    :func:`make_preprocess_fn` of them. A list-valued size takes its first
    entry; an interpolation other than bilinear, bicubic or nearest becomes
    bicubic.
    """

    def _scalar(v, default):
        if v is None:
            return default
        if isinstance(v, (list, tuple)):
            return int(v[0])
        return int(v)

    size = _scalar(getattr(instance, "resize_size", None), 256)
    crop = _scalar(getattr(instance, "crop_size", None), size)
    interp = str(getattr(instance, "interpolation", "bicubic")).split(".")[-1].lower()
    if interp not in ("bilinear", "bicubic", "nearest"):
        interp = "bicubic"
    return make_preprocess_fn(
        size=size,
        crop=crop,
        mean=tuple(getattr(instance, "mean", (0.485, 0.456, 0.406))),
        std=tuple(getattr(instance, "std", (0.229, 0.224, 0.225))),
        interpolation=interp,
    )


def get_denormalization_transform(
    mean: Sequence[float] = (0.485, 0.456, 0.406),
    std: Sequence[float] = (0.229, 0.224, 0.225),
):
    """A function undoing channel normalization: ``x * std + mean`` over the last axis.

    Takes ``(..., H, W, C)`` channels-last arrays, as the JAX package's
    does: numpy in, float32 numpy out; a tensor stays a float32 tensor on
    its device.
    """
    mean_arr = np.asarray(mean, dtype=np.float32)
    std_arr = np.asarray(std, dtype=np.float32)

    def denormalize(x):
        if isinstance(x, torch.Tensor):
            x = x.float()
            return x * torch.from_numpy(std_arr).to(x.device) + torch.from_numpy(mean_arr).to(x.device)
        return np.asarray(x, dtype=np.float32) * std_arr + mean_arr

    return denormalize
