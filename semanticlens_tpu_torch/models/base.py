"""Subject-model protocol: functional forward with named activation taps.

Counterpart of ``semanticlens_tpu.models.base``. A subject model implements

    logits, taps = model.apply(params, x, tap_names=("layer4", ...))

``x`` is a (B, H, W, C) batch and conv taps come back as (B, H, W, C), the
JAX package's layout, so aggregators, caches and tests see the same arrays
from both packages. Models expose ``module_names`` so layer validation keeps
the reference API promise (``layer_names=["layer4"]``).

The JAX package's ``interventions`` stack is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch


class TapCollector:
    """Accumulates activations for a static set of requested tap names."""

    def __init__(self, tap_names: Sequence[str]):
        self.requested = frozenset(tap_names)
        self.taps: dict[str, torch.Tensor] = {}

    def __call__(self, name: str, value):
        """Record ``value`` under ``name`` if requested; returns ``value``.

        Recording twice under one name keeps the last write (torch hook
        semantics for modules invoked more than once).
        """
        if name in self.requested:
            self.taps[name] = value
        return value


class SubjectModel:
    """Base class for functional subject models.

    Subclasses define ``module_names``, ``device`` (where the forward runs),
    ``init(seed) -> params`` and ``apply(params, x, tap_names) -> (output,
    {name: activation})``.
    Instances may carry ``.params`` and ``.name`` for the
    ActivationComponentVisualizer.
    """

    module_names: tuple[str, ...] = ()

    def init(self, seed: int = 0) -> dict:
        raise NotImplementedError

    def apply(self, params: Mapping, x, tap_names: Sequence[str] = ()):
        raise NotImplementedError

    def has_module(self, name: str) -> bool:
        return name in self.module_names


def validate_layers(model: SubjectModel, layer_names: Sequence[str]) -> None:
    """Raise ValueError for unknown layer names."""
    for layer in layer_names:
        if not model.has_module(layer):
            raise ValueError(f"Layer '{layer}' not found in model.")

