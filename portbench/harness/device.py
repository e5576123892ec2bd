"""The card a run measures: its presence, name, power limit and memory peak; the run's cache directories."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

#: Top-level modules that may never be loaded in a run: the JAX stack and the JAX package.
#: Compared whole, so ``semanticlens_tpu_torch`` (the program) is not among them.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "semanticlens_tpu")


class NoCard(RuntimeError):
    """The run asked for more CUDA cards than this machine shows."""


def set_cache_dirs(root: Path) -> None:
    """Point every compile cache at a fixed directory inside the checkout (set before torch loads)."""
    cache = root / "portbench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"  # transformers, if anything loads it, must not load JAX
    os.environ["USE_TF"] = "0"


def forbidden_loaded() -> list[str]:
    """The forbidden top-level modules present in ``sys.modules``."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def require_cards(chips: int):
    """The first CUDA device, after checking that ``chips`` cards are there; raises :class:`NoCard` otherwise."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this run needs a CUDA card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, torch sees {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def power_limit_w() -> float | None:
    """The first card's power limit in watts, from ``nvidia-smi`` (None where it cannot be read)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (subprocess.SubprocessError, ValueError, IndexError):
        return None


def clocks() -> str:
    """The first card's SM clock, memory clock, temperature and power draw from ``nvidia-smi`` (a diagnostic)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "no nvidia-smi"
    try:
        return subprocess.run([smi, "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,power.draw",
                               "--format=csv,noheader", "-i", "0"], capture_output=True, text=True, timeout=30,
                              check=True).stdout.strip()
    except subprocess.SubprocessError as err:
        return f"nvidia-smi failed: {err}"


def memory_peak_bytes(device) -> int:
    """The allocator's peak on ``device`` so far (0 off the card)."""
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def describe(device, chips: int, peak_bytes: int) -> dict:
    """The result line's ``device``: platform, card name, card count, memory peak, and the power limit."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": peak_bytes, "power_limit_w": power_limit_w()}
