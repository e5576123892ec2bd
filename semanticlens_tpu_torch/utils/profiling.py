"""Stage timing and device profiling.

Counterpart of ``semanticlens_tpu.utils.profiling``:

- :class:`StageTimer` — wall-clock seconds and items/s per pipeline stage,
  logged through the package logger and returned as a dict by
  :meth:`StageTimer.summary` (the entry points' ``"stages"`` report);
- :func:`force_materialize` — copy every tensor of a nested structure to the
  host, a timing barrier that waits for the work that made them;
- :func:`device_trace` — a ``torch.profiler`` trace of the CPU and, where
  there is one, the CUDA card, written as a Chrome trace under ``log_dir``.

PyTorch returns from a CUDA call before the card finishes it, so a stage
that ran on the card synchronizes it on exit: otherwise its seconds would
end before its kernels do.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from pathlib import Path

import torch

logger = logging.getLogger(__name__)


class StageTimer:
    """Accumulates per-stage wall-clock and throughput."""

    def __init__(self):
        self.stages: dict[str, dict] = {}

    @contextmanager
    def stage(self, name: str, items: int | None = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():  # the stage's kernels end inside its seconds
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            entry = self.stages.setdefault(name, {"seconds": 0.0, "items": 0})
            entry["seconds"] += dt
            if items:
                entry["items"] += items
            per_sec = f", {items / dt:.1f} items/s" if items else ""
            logger.info(f"[stage:{name}] {dt:.3f}s{per_sec}")

    def summary(self) -> dict[str, dict]:
        out = {}
        for name, e in self.stages.items():
            out[name] = dict(e)
            if e["items"]:
                out[name]["items_per_sec"] = e["items"] / e["seconds"]
        return out


def force_materialize(tree):
    """Copy every tensor in a nested dict/list/tuple to the host (honest timing barrier)."""
    if isinstance(tree, torch.Tensor):
        tree.cpu()
    elif isinstance(tree, dict):
        for value in tree.values():
            force_materialize(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            force_materialize(value)


@contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace context; writes ``{log_dir}/trace.json`` (chrome://tracing, Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path / "trace.json"))
    logger.info(f"Wrote device trace to {path / 'trace.json'}")
