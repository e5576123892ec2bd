"""A ``torch.profiler`` trace of a slice of the window, read as intervals.

The slice is exported as a Chrome trace into a temporary directory under
``TMPDIR`` (a few MB, deleted once read) and reduced to three lists of
``(start_s, end_s, name)`` on the trace's clock, which the host and device
events share:

- ``device``: kernels, copies and memsets on the card;
- ``annotations``: the benchmark's own ``portbench.*`` annotations;
- ``host``: the host's operator calls.

What is read from them: the union of device intervals inside a window
(busy seconds), the idle gaps between them, each labelled with the
innermost host annotation or operator under way when it began, and the
device operations by total time.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import tempfile
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Trace:
    def __init__(self, device: list, annotations: list, host: list):
        self.device = sorted(device)
        self.annotations = sorted(annotations)
        self.host = sorted(host)

    def windows(self, name: str) -> list[tuple[float, float]]:
        """The (start, end) of every annotation named ``name``."""
        return [(s, e) for s, e, n in self.annotations if n == name]

    def merged(self, lo: float, hi: float) -> list[tuple[float, float]]:
        """Device intervals clipped to [lo, hi] and merged where they overlap."""
        out: list[list[float]] = []
        for s, e, _ in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self, lo: float, hi: float) -> float:
        return sum(e - s for s, e in self.merged(lo, hi))

    def gaps(self, lo: float, hi: float) -> list[tuple[float, float]]:
        """Idle stretches of the device inside [lo, hi]."""
        out, cursor = [], lo
        for s, e in self.merged(lo, hi):
            if s > cursor:
                out.append((cursor, s))
            cursor = max(cursor, e)
        if hi > cursor:
            out.append((cursor, hi))
        return out

    def host_label(self, t: float) -> str:
        """The innermost annotation or host operator under way at ``t``, or ``"host"``."""
        best = None
        for s, e, n in self.annotations + self.host:
            if s <= t < e and (best is None or s >= best[0]):
                best = (s, n)
        return best[1] if best else "host"

    def breakdown(self, lo: float, hi: float) -> dict:
        """``device_ops``: the device operations by total seconds; ``idle_gaps``: the longest gaps, labelled."""
        by_name: dict[str, float] = {}
        for s, e, n in self.device:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps(lo, hi), key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n, t] for n, t in ops],
                "idle_gaps": [[self.host_label(s), e - s] for s, e in gaps]}


def parse(events: list[dict]) -> Trace:
    device, annotations, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        item = (float(ev["ts"]) * 1e-6, (float(ev["ts"]) + float(ev["dur"])) * 1e-6, str(ev.get("name", "")))
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(item)
        elif cat == "user_annotation" and item[2].startswith("portbench."):
            annotations.append(item)
        elif cat == "cpu_op":
            host.append(item)
    return Trace(device, annotations, host)


@contextlib.contextmanager
def profiled(sink: list, device):
    """Profile the body; afterwards append its :class:`Trace` to ``sink``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    tmp = Path(tempfile.mkdtemp(prefix="portbench-trace-"))
    try:
        path = tmp / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            sink.append(parse(json.load(f)["traceEvents"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
