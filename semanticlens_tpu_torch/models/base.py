"""Subject-model protocol: functional forward with named activation taps.

Counterpart of ``semanticlens_tpu.models.base``. A subject model implements

    logits, taps = model.apply(params, x, tap_names=("layer4", ...))

``x`` is a (B, H, W, C) batch and conv taps come back as (B, H, W, C), the
JAX package's layout, so aggregators, caches and tests see the same arrays
from both packages. Models expose ``module_names`` so layer validation keeps
the reference API promise (``layer_names=["layer4"]``).

The :func:`interventions` context rewrites named activations during
``apply``: every model routes its activations through :class:`TapCollector`,
which applies the active rewrites, so ablation, patching and steering
(:mod:`semanticlens_tpu_torch.causal`) reach every family with no per-model
code.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Callable, Mapping, Sequence

import torch

# Per-thread stack of active intervention maps (name -> fn(value) -> value),
# appended by the `interventions` context manager and consulted by every
# TapCollector call. Thread-local like the LRP composite state in
# models/layers.py: a forward on another thread must not see this thread's
# rewrites. Each entry carries a unique token (``interventions_fingerprint``).
_TLS = threading.local()
_TOKENS = itertools.count()


def _active_stack() -> list[tuple[int, dict[str, Callable]]]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def interventions_fingerprint() -> tuple[int, ...]:
    """Tokens of the interventions contexts active on this thread; ``()`` when clean.

    Code that memoizes a captured program whose capture consults
    interventions must key on this. The port runs its forwards eagerly and
    memoizes none (``collect/engine.py`` says why it needs no such key).
    """
    return tuple(token for token, _ in _active_stack())


def has_intervention(name: str) -> bool:
    """True when an active ``interventions`` context targets ``name``.

    Models use it to route to an intervention-capable formulation of a
    virtual tap (the per-head attention taps) only when someone rewrites it,
    keeping the plain forward identical to the untapped one.
    """
    return any(name in mapping for _, mapping in _active_stack())


def apply_interventions(name: str, value):
    """Run the active intervention fns registered for ``name``, outermost
    context first (the order :class:`TapCollector` applies them). Returns
    ``value`` unchanged when nothing targets the name."""
    for _, mapping in _active_stack():
        fn = mapping.get(name)
        if fn is not None:
            value = fn(value)
    return value


@contextlib.contextmanager
def interventions(mapping: Mapping[str, Callable]):
    """Intervene on named activations during ``model.apply``.

    ``mapping`` takes a module name (any entry of ``model.module_names``) to
    a function ``fn(value) -> value``; the returned tensor REPLACES the
    activation for everything downstream — the semantics of a torch forward
    hook that returns a modified output. ``fn`` sees the activation in the
    taps' layout: (B, H, W, C) for conv layers, (B, T, C) for tokens.

    Interventions compose with taps: a requested tap records the
    POST-intervention value (what the network saw downstream). Contexts
    nest; the outermost rewrite runs first.
    """
    _active_stack().append((next(_TOKENS), dict(mapping)))
    try:
        yield
    finally:
        _active_stack().pop()


class TapCollector:
    """Accumulates activations for a static set of requested tap names.

    ``channels_first=True`` declares that rank-4 values arrive as NCHW
    tensors (the port's ResNet runs NCHW in channels_last memory): an
    intervention sees them as the (B, H, W, C) view and its result goes
    back as NCHW, so a rewrite is the same function in both packages.
    """

    def __init__(self, tap_names: Sequence[str], channels_first: bool = False):
        self.requested = frozenset(tap_names)
        self.channels_first = channels_first
        self.taps: dict[str, torch.Tensor] = {}

    def __call__(self, name: str, value):
        """Record ``value`` under ``name`` if requested; returns ``value``.

        Active ``interventions`` rewrite ``value`` first (outermost context
        first), so downstream compute and the recorded tap both see the
        intervened activation. Recording twice under one name keeps the last
        write (torch hook semantics for modules invoked more than once).
        """
        if has_intervention(name):
            if self.channels_first and value.ndim == 4:
                value = apply_interventions(name, value.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            else:
                value = apply_interventions(name, value)
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


#: A layer's aggregation: (B, ...) activations → (B, C) per-component scores.
AggregationFn = Callable[[torch.Tensor], torch.Tensor]
