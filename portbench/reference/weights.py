"""Random weights from a seed, drawn on the device in two large calls.

A model's tensors are listed as ``(name, torch shape, draw)`` rows by its
reference module. All normal draws come from one ``torch.randn`` buffer
and all uniform draws from one ``torch.rand`` buffer of a
``torch.Generator`` seeded with the run's seed, on the device the weights
are used on; each tensor is a slice of them, scaled. Draws:

- ``("normal", std)``: N(0, std²);
- ``("scale", spread)``: 1 + spread · N(0, 1) (norm and BN scales with a
  trained-like spread);
- ``("var",)``: U(0.5, 1.5) (BN running variances);
- ``("const", value)``: the value.

``dtype`` gives the type of the matrices and convolution kernels (2-D and
4-D tensors); the rest stay float32. Both sides of a comparison are handed
the same tensors, so rounding the weights to the served type is not part
of any error the comparison reads.
"""

from __future__ import annotations

import math

import torch

SEED_MASK = (1 << 63) - 1
#: The random streams of one run: each input of the benchmark draws from its own.
STREAMS = {"subject": 1, "fm": 2, "images": 3, "bank": 4, "sample": 5, "calibration": 6, "queries": 1000}


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for (seed, stream): distinct streams of one run never share draws."""
    mixed = (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) & SEED_MASK
    return torch.Generator(device=device).manual_seed(mixed)


def draw(specs, seed: int, stream: int, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``specs`` on ``device``, from (seed, stream)."""
    gen = generator(seed, stream, device)
    n_normal = sum(math.prod(shape) for _, shape, how in specs if how[0] in ("normal", "scale"))
    n_uniform = sum(math.prod(shape) for _, shape, how in specs if how[0] == "var")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out, i_n, i_u = {}, 0, 0
    for name, shape, how in specs:
        size = math.prod(shape)
        if how[0] == "normal":
            t = normal[i_n : i_n + size].view(shape) * how[1]
            i_n += size
        elif how[0] == "scale":
            t = 1.0 + how[1] * normal[i_n : i_n + size].view(shape)
            i_n += size
        elif how[0] == "var":
            t = 0.5 + uniform[i_u : i_u + size].view(shape)
            i_u += size
        elif how[0] == "const":
            t = torch.full(shape, float(how[1]), device=device)
        else:
            raise ValueError(f"{name}: unknown draw {how!r}")
        out[name] = t.to(dtype) if len(shape) in (2, 4) else t.clone()
    return out


def as_float32(params: dict) -> dict[str, torch.Tensor]:
    """The same tensors in float32 (exact: every served type widens to float32 without rounding)."""
    return {name: t.to(torch.float32) for name, t in params.items()}
