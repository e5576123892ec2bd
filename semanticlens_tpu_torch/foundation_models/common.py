"""Shared helpers for foundation-model implementations."""

from __future__ import annotations

import math

import numpy as np


def init_from_specs(seed: int, specs) -> dict[str, np.ndarray]:
    """Random float32 numpy weights from (name, shape, kind) specs, JAX layout.

    The JAX package's scheme: ``ones`` / ``zeros`` / ``logit_scale``
    (ln(1/0.07)) / ``logit_scale_siglip`` (ln 10) / ``embed`` (σ=0.02) /
    anything else → normal with σ = fan_in**-0.5, drawn from ``np.random``
    with ``seed``.
    """
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape, kind in specs:
        if kind == "ones":
            params[name] = np.ones(shape, np.float32)
        elif kind == "zeros":
            params[name] = np.zeros(shape, np.float32)
        elif kind == "logit_scale":
            params[name] = np.asarray(math.log(1 / 0.07), np.float32)
        elif kind == "logit_scale_siglip":
            params[name] = np.asarray(math.log(10.0), np.float32)
        else:
            fan_in = shape[0] if len(shape) <= 2 else int(np.prod(shape[:-1]))
            std = 0.02 if kind == "embed" else fan_in**-0.5
            params[name] = rng.standard_normal(shape, np.float32) * np.float32(std)
    return params
