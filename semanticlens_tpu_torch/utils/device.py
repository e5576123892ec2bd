"""Device resolution for the port's entry points.

Every entry point runs on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the CPU tests do). With no card and no explicit CPU
request it raises: a run meant for the card never falls back quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises when no CUDA device exists); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """Tensor on ``device``; a tensor keeps its own device when ``device`` is None.

    numpy inputs (and anything ``torch.as_tensor`` takes) land on
    :func:`resolve_device` ``(device)``.
    """
    if isinstance(x, torch.Tensor):
        return x.to(device=x.device if device is None else resolve_device(device), dtype=dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))
