"""Collect: per-component concept examples from a subject model."""

from semanticlens_tpu_torch.collect.activation_based import ActivationComponentVisualizer
from semanticlens_tpu_torch.collect.activation_caching import ActMax, ActMaxCache
from semanticlens_tpu_torch.collect.engine import CollectEngine
from semanticlens_tpu_torch.collect.relevance_based import RelevanceComponentVisualizer
from semanticlens_tpu_torch.collect.sae_based import SAEComponentVisualizer

__all__ = ["ActMax", "ActMaxCache", "ActivationComponentVisualizer", "CollectEngine",
           "RelevanceComponentVisualizer", "SAEComponentVisualizer"]
