"""Inputs made from the seed on the device, in bulk: images and component banks."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.weights import STREAMS, generator

CHUNK = 512


def scenes(gen: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """(n, size, size, 3) uint8 scenes, each unlike the others: a colour gradient, a grating of its own
    frequency, orientation and strength, five discs of random colours and sensor noise of its own level."""

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    axis = torch.linspace(0.0, 1.0, size, device=device)
    y, x = axis.view(1, size, 1, 1), axis.view(1, 1, size, 1)
    img = 255 * rand(n, 1, 1, 3) + (255 * rand(n, 1, 1, 3) - 128) * x + (255 * rand(n, 1, 1, 3) - 128) * y
    angle, freq = math.pi * rand(n, 1, 1, 1), 2.0 + 60.0 * rand(n, 1, 1, 1) ** 2
    phase = 2 * math.pi * rand(n, 1, 1, 1)
    grating = torch.sin(freq * (x * torch.cos(angle) + y * torch.sin(angle)) * 2 * math.pi + phase)
    img = img + 80 * rand(n, 1, 1, 1) * grating * (rand(n, 1, 1, 3) - 0.5) * 2
    for _ in range(5):
        cy, cx = rand(n, 1, 1, 1), rand(n, 1, 1, 1)
        radius = 0.04 + 0.3 * rand(n, 1, 1, 1)
        img = torch.where((y - cy) ** 2 + (x - cx) ** 2 < radius**2, 255 * rand(n, 1, 1, 3), img)
    img = img + 30 * rand(n, 1, 1, 1) * torch.randn(n, size, size, 3, generator=gen, device=device)
    return img.clamp_(0, 255).round_().to(torch.uint8)


def images(seed: int, n: int, size: int, device) -> np.ndarray:
    """``n`` distinct scenes from ``seed``, made on ``device`` and held in host memory."""
    gen = generator(seed, STREAMS["images"], device)
    out = np.empty((n, size, size, 3), np.uint8)
    for start in range(0, n, CHUNK):
        m = min(CHUNK, n - start)
        out[start : start + m] = scenes(gen, m, size, device).cpu().numpy()
    return out


def bank(seed: int, rows: int, dim: int, device) -> torch.Tensor:
    """(rows, dim) float32 component vectors, N(0, 1), from ``seed``."""
    return torch.randn(rows, dim, generator=generator(seed, STREAMS["bank"], device), device=device)


def queries(seed: int, call: int, rows: int, dim: int, device) -> torch.Tensor:
    """The (rows, dim) float32 queries of call ``call``, from (``seed``, ``call``)."""
    gen = generator(seed, STREAMS["queries"] + call, device)
    return torch.randn(rows, dim, generator=gen, device=device)
