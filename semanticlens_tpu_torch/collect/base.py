"""Abstract base class for component visualizers.

Counterpart of ``semanticlens_tpu.collect.base``: the interface every
Collect strategy implements — run, concept-DB computation, max-reference
lookup, metadata/caching/storage contract.
"""

from __future__ import annotations

from abc import ABC, abstractmethod


class AbstractComponentVisualizer(ABC):
    """Identifies the concept examples encoded by a model's components."""

    @abstractmethod
    def run(self, *args, **kwargs):
        """Process the dataset to find per-component concept examples."""
        raise NotImplementedError

    @abstractmethod
    def _compute_concept_db(self, fm, **kwargs) -> dict:
        """Embed each component's concept examples with foundation model ``fm``.

        Returns ``{layer_name: (n_components, n_samples, embedding_dim)}``.
        """
        raise NotImplementedError

    @abstractmethod
    def get_max_reference(self, layer_name):
        """(n_components, n_samples) dataset indices of top examples."""
        raise NotImplementedError

    @property
    def metadata(self) -> dict[str, str]:
        raise NotImplementedError

    @property
    @abstractmethod
    def caching(self) -> bool:
        raise NotImplementedError

    @property
    @abstractmethod
    def storage_dir(self):
        raise NotImplementedError
