"""Stage timing, the program's tracer and device profiling.

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

The tracer (port only): :func:`span` marks a stretch of the program's work
and :func:`count` counts events where the work happens. Spans are off by
default and cost one flag test then; :func:`enable` or
``SEMANTICLENS_TRACE=1`` (read once, at import) turns them on. An enabled
span records its calls and host milliseconds; given a CUDA device it also
records the device milliseconds between two CUDA events on that device's
current stream (for a span that enqueues nothing there: the card's idle
time inside it). The events resolve when a host span opens, or past
``KEEP`` pending pairs, once the card has passed them, so the hot path does
not wait for the card (unless it runs 2 × ``KEEP`` spans behind). Under
an active ``torch.profiler`` each enabled span is a
``record_function("semanticlens.<name>")`` annotation, on the clock of the
kernels and operators it encloses. Counters are always on, and so are
tallies: :func:`tally` keeps a reference to a small tensor of counts that
the work made where it runs (an MoE layer's tokens per expert, on the card),
without reading it. :func:`snapshot` synchronizes once and returns the
spans, the counters and the tallies' values, :func:`counters` the counters
alone without a wait; :func:`reset` clears them.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from pathlib import Path

import torch

logger = logging.getLogger(__name__)

KEEP = 4096  # per-call values kept per span (the last calls); unresolved event pairs kept before resolving

_on = os.environ.get("SEMANTICLENS_TRACE", "0") not in ("", "0")
_OFF = contextlib.nullcontext()  # what every span is while the tracer is off
_lock = threading.Lock()
_stats: dict[str, "_Stat"] = {}
_counts: dict[str, int] = {}
_pending: deque = deque()  # (stat, start event, stop event), oldest first
_tallies: dict[str, deque] = {}  # name → the last KEEP tensors of counts, unread


class _Stat:
    """One span's totals and its last ``KEEP`` per-call values."""

    __slots__ = ("calls", "host_ms", "device_ms", "recent_host_ms", "recent_device_ms")

    def __init__(self):
        self.calls, self.host_ms, self.device_ms = 0, 0.0, None
        self.recent_host_ms: deque = deque(maxlen=KEEP)
        self.recent_device_ms: deque = deque(maxlen=KEEP)

    def add_device(self, ms: float):
        self.device_ms = ms if self.device_ms is None else self.device_ms + ms
        self.recent_device_ms.append(ms)


def _resolve(wait: bool) -> None:
    """Turn the pending event pairs into device milliseconds, oldest first (caller holds the lock).

    ``wait``: all of them, waiting for the card; else those the card has passed.
    """
    while _pending:
        stat, start, stop = _pending[0]
        if wait:
            stop.synchronize()
        elif not stop.query():
            return
        _pending.popleft()
        stat.add_device(start.elapsed_time(stop))


class _Span:
    __slots__ = ("name", "device", "annotation", "start", "t0")

    def __init__(self, name: str, device):
        self.name, self.device = name, device  # a CUDA device, or None for a host span

    def __enter__(self):
        if self.device is None and _pending:  # the host is seldom ahead of the card here: settle what it passed
            with _lock:
                _resolve(wait=False)
        self.annotation = None
        if torch._C._autograd._profiler_enabled():  # no profiler, no annotation to record
            self.annotation = torch.profiler.record_function("semanticlens." + self.name)
            self.annotation.__enter__()
        if self.device is not None:  # recorded on the device's current stream
            self.start = torch.Event(self.device, enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ms = (time.perf_counter_ns() - self.t0) * 1e-6
        stop = None
        if self.device is not None:
            stop = torch.Event(self.device, enable_timing=True)
            stop.record()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        with _lock:
            stat = _stats.get(self.name)
            if stat is None:
                stat = _stats[self.name] = _Stat()
            stat.calls += 1
            stat.host_ms += host_ms
            stat.recent_host_ms.append(host_ms)
            if stop is not None:
                _pending.append((stat, self.start, stop))
                if len(_pending) > KEEP:  # no host span to settle them: bound the memory here
                    _resolve(wait=len(_pending) > 2 * KEEP)
        return False


def span(name: str, device: torch.device | None = None):
    """A context manager that records the stretch of work it encloses as span ``name``.

    Off (the default), the shared no-op context. On, a host span, or with a
    CUDA ``device`` a device span as well (on the CPU a device span records
    its host time alone).
    """
    if not _on:
        return _OFF
    return _Span(name, device if device is not None and device.type == "cuda" else None)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (always on)."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def tally(name: str, values: torch.Tensor) -> None:
    """Keep ``values``, a 1-D tensor of counts on any device, as one call of tally ``name`` (always on).

    Nothing is read or copied here: :func:`snapshot` reads the last ``KEEP``
    calls of every tally after its one wait. The caller hands over a tensor
    it no longer writes.
    """
    with _lock:
        kept = _tallies.get(name)
        if kept is None:
            kept = _tallies[name] = deque(maxlen=KEEP)
        kept.append(values)


def _read_tallies() -> dict[str, list[list[int]]]:
    """Every kept tally call's values on the host, in one copy (caller holds the lock)."""
    calls = [(name, t.reshape(-1)) for name, kept in _tallies.items() for t in kept]
    device = calls[0][1].device
    flat = torch.cat([t.to(device, torch.int64) for _, t in calls]).tolist()
    out: dict[str, list[list[int]]] = {}
    start = 0
    for name, t in calls:
        out.setdefault(name, []).append(flat[start : start + t.numel()])
        start += t.numel()
    return out


def counters() -> dict:
    """Every counter since the last :func:`reset`, without waiting for the card or copying a span."""
    with _lock:
        return dict(_counts)


def enable(on: bool = True) -> None:
    """Turn spans on or off for the whole process."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def snapshot() -> dict:
    """Every span, counter and tally since the last :func:`reset`; waits once for the card.

    ``{"spans": {name: {"calls", "host_ms", "device_ms", "recent_host_ms",
    "recent_device_ms"}}, "counters": {name: int}}``: totals over every call
    (``device_ms`` is None for a span that recorded no CUDA events) and the
    per-call values of the last ``KEEP`` calls, oldest first; with
    ``"tallies": {name: [[int, ...], ...]}`` too once a tally was kept.
    """
    with _lock:
        _resolve(wait=True)
        spans = {name: {"calls": s.calls, "host_ms": s.host_ms, "device_ms": s.device_ms,
                        "recent_host_ms": list(s.recent_host_ms), "recent_device_ms": list(s.recent_device_ms)}
                 for name, s in _stats.items()}
        snap = {"spans": spans, "counters": dict(_counts)}
        if _tallies:
            snap["tallies"] = _read_tallies()
        return snap


def reset(*names: str) -> None:
    """Clear the spans, counters and tallies named, or all of them when none is named."""
    with _lock:
        if not names:
            _stats.clear()
            _counts.clear()
            _pending.clear()
            _tallies.clear()
            return
        for name in names:  # a pending pair of a cleared span resolves into a stat no longer listed
            _counts.pop(name, None)
            _stats.pop(name, None)
            _tallies.pop(name, None)


class StageTimer:
    """Accumulates per-stage wall-clock and throughput."""

    def __init__(self):
        self.stages: dict[str, dict] = {}

    @contextmanager
    def stage(self, name: str, items: int | None = None):
        t0 = time.perf_counter()
        try:
            with span(f"stage.{name}"):
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
