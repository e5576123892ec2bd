"""Helpers: device resolution, cache naming, preprocessing, the safetensors layout."""

from semanticlens_tpu_torch.utils.device import resolve_device
from semanticlens_tpu_torch.utils.helper import (
    get_denormalization_transform,
    get_fallback_name,
    make_preprocess_fn,
    to_transforms_compose,
)

__all__ = ["get_denormalization_transform", "get_fallback_name", "make_preprocess_fn", "resolve_device",
           "to_transforms_compose"]
