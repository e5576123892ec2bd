"""Spans the benchmark records around the program's public calls, in traced runs only.

``Spans.wrap(name, fn)`` returns ``fn`` timed on the device: a CUDA event
before and after the host call, on the current stream, so the span is the
device time from the first work the call enqueued to the last (on the CPU,
the host time of the call). Each call is also a ``torch.profiler``
annotation ``portbench.<name>``, which labels the idle gaps of a trace.
Nothing is recorded while ``active`` is false, so the warm-up is not
counted; with ``annotate`` alone (a profiled stretch) the calls are only
annotated. Host spans (``host``) take milliseconds measured by the caller.
"""

from __future__ import annotations

import time

import torch


class Spans:
    def __init__(self, device):
        self.device = device
        self.active = False
        self.annotate = False
        self._pairs: dict[str, list] = {}
        self.host: dict[str, list[float]] = {}

    def wrap(self, name: str, fn, *, rows_arg: int | None = None, rows: int | None = None):
        """``fn`` with a span named ``name``; with ``rows``, only calls whose positional argument
        ``rows_arg`` has that many rows are recorded (a one-image probe is not a batch)."""
        on_card = self.device.type == "cuda"

        def wrapped(*args, **kwargs):
            if rows is not None and args[rows_arg].shape[0] != rows or not (self.active or self.annotate):
                return fn(*args, **kwargs)
            if not self.active:
                with torch.profiler.record_function(f"portbench.{name}"):
                    return fn(*args, **kwargs)
            with torch.profiler.record_function(f"portbench.{name}"):
                if on_card:
                    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = fn(*args, **kwargs)
                    stop.record()
                else:
                    start = time.perf_counter()
                    out = fn(*args, **kwargs)
                    stop = time.perf_counter()
            self._pairs.setdefault(name, []).append((start, stop))
            return out

        return wrapped

    def add_host(self, name: str, ms: float) -> None:
        if self.active:
            self.host.setdefault(name, []).append(ms)

    def device_ms(self) -> dict[str, list[float]]:
        """Each wrapped call's milliseconds, by span name (waits for the card)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return {name: [a.elapsed_time(b) for a, b in pairs] for name, pairs in self._pairs.items()}
        return {name: [1e3 * (b - a) for a, b in pairs] for name, pairs in self._pairs.items()}
