"""Helpers: device resolution, cache naming, the safetensors layout."""

from semanticlens_tpu_torch.utils.device import resolve_device
from semanticlens_tpu_torch.utils.helper import get_fallback_name, make_preprocess_fn

__all__ = ["get_fallback_name", "make_preprocess_fn", "resolve_device"]
