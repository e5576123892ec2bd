"""Helpers: device resolution, cache naming, preprocessing, logging, timing and tracing, the safetensors layout."""

from semanticlens_tpu_torch.utils.device import resolve_device
from semanticlens_tpu_torch.utils.helper import (
    get_denormalization_transform,
    get_fallback_name,
    make_preprocess_fn,
    to_transforms_compose,
)
from semanticlens_tpu_torch.utils.log_setup import setup_colored_logging
from semanticlens_tpu_torch.utils.profiling import (
    StageTimer,
    count,
    counters,
    device_trace,
    enable,
    enabled,
    force_materialize,
    reset,
    snapshot,
    span,
    tally,
)

__all__ = ["get_denormalization_transform", "get_fallback_name", "make_preprocess_fn", "resolve_device",
           "to_transforms_compose", "setup_colored_logging", "StageTimer", "device_trace", "force_materialize",
           "span", "count", "counters", "enable", "enabled", "snapshot", "reset", "tally"]
