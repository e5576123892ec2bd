"""Vision-language foundation models."""

from semanticlens_tpu_torch.foundation_models.base import AbstractVLM
from semanticlens_tpu_torch.foundation_models.clip import OpenClip

__all__ = ["AbstractVLM", "OpenClip"]
