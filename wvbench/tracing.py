"""The benchmark's own spans, and the reduction of a torch.profiler trace
to the device's busy time, the kernels' summed time, the busiest device
operations and the longest idle gaps; of a trace of the device's work
alone, to the kernels' summed time.

Spans are `torch.profiler.record_function` ranges named `wvbench.<part>`
around the calls into the program (parse, decode_states, join, encode),
plus `wvbench.window` around the measured loop; each part's host time is
also summed on the host clock. An idle gap is labelled by the innermost
span the host was in at its middle. The profiler mirrors each span on
the device's timeline as an annotation; those mirrors are no device work
and are left out.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

PREFIX = "wvbench."
WINDOW = PREFIX + "window"


class Spans:
    """Host-clock sums of the benchmark's spans; with `record`, each span
    is also a profiler range."""

    def __init__(self, record: bool):
        self.record = record
        self.seconds: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = contextlib.nullcontext()
        if self.record:
            import torch
            ctx = torch.profiler.record_function(PREFIX + name)
        t0 = time.perf_counter()
        with ctx:
            try:
                yield
            finally:
                self.seconds[name] += time.perf_counter() - t0


def _events(prof):
    """(name, on_device, start_us, end_us) of every traced event."""
    from torch.autograd import DeviceType
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    try:
        rows = []
        for e in results.events():
            if hasattr(e, "start_ns"):
                start = e.start_ns() / 1e3
                dur = e.duration_ns() / 1e3
            else:
                start, dur = e.start_us(), e.duration_us()
            rows.append((e.name(), e.device_type() == DeviceType.CUDA,
                         start, start + dur))
        yield from rows
        return
    except AttributeError:      # no kineto results in this torch
        pass
    for e in prof.events():
        yield (e.name, e.device_type == DeviceType.CUDA,
               e.time_range.start, e.time_range.end)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", PREFIX))


def kernel_seconds(prof) -> float:
    """Summed time of every kernel in a trace of the device's work alone
    (copies and span mirrors left out); 0 without device events."""
    return sum(e - s for name, on_device, s, e in _events(prof)
               if on_device and _is_kernel(name)) / 1e6


def reduce(prof, top: int = 10) -> dict:
    """busy_s, window_s, kernel_s (summed kernel time, copies excluded),
    device_ops and idle_gaps ([name, seconds], longest first) of the
    traced `wvbench.window`; busy_s and kernel_s are 0 where the trace
    holds no device event."""
    window = None
    spans, dev = [], []
    for name, on_device, s, e in _events(prof):
        if on_device:
            if not name.startswith(PREFIX):   # not a span's mirror
                dev.append((s, e, name))
        elif name == WINDOW:
            window = (s, e)
        elif name.startswith(PREFIX):
            spans.append((s, e, name))
    if window is None:
        raise RuntimeError("the trace holds no wvbench.window range")
    w0, w1 = window
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in dev])
    by_name: dict[str, float] = defaultdict(float)
    kernel_us = 0.0
    for s, e, n in dev:
        by_name[n] += e - s
        if _is_kernel(n):
            kernel_us += e - s
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)

    def label(a, b):
        mid = (a + b) / 2
        inside = [(e - s, n) for s, e, n in spans if s <= mid <= e]
        return min(inside)[1] if inside else "outside the benchmark's spans"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "kernel_s": kernel_us / 1e6,
        "device_ops": [[n, us / 1e6] for n, us in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[label(a, b), (b - a) / 1e6] for a, b in gaps[:top]],
    }
