"""Collect: per-component concept examples from a subject model."""

from semanticlens_tpu_torch.collect.activation_based import ActivationComponentVisualizer, MissingNameWarning
from semanticlens_tpu_torch.collect.activation_caching import (
    DEFAULT_AGGREGATION_FUNCTION_MAP,
    ActCache,
    ActMax,
    ActMaxCache,
)
from semanticlens_tpu_torch.collect.base import AbstractComponentVisualizer
from semanticlens_tpu_torch.collect.engine import CollectEngine
from semanticlens_tpu_torch.collect.relevance_based import RelevanceComponentVisualizer
from semanticlens_tpu_torch.collect.sae_based import SAEComponentVisualizer
from semanticlens_tpu_torch.collect.synthesis_based import SynthesisComponentVisualizer
from semanticlens_tpu_torch.collect.text_based import (
    TextActivationComponentVisualizer,
    TextSAEComponentVisualizer,
    TokenTextDataset,
)

__all__ = ["AbstractComponentVisualizer", "ActCache", "ActMax", "ActMaxCache", "ActivationComponentVisualizer",
           "CollectEngine", "DEFAULT_AGGREGATION_FUNCTION_MAP", "MissingNameWarning",
           "RelevanceComponentVisualizer", "SAEComponentVisualizer", "SynthesisComponentVisualizer",
           "TextActivationComponentVisualizer", "TextSAEComponentVisualizer", "TokenTextDataset"]
