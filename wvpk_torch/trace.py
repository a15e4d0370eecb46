"""Tracing / profiling (SURVEY.md section 5.1).

The reference's only instrumentation is a Stopwatch around the decode loop
(WvDemo.cs:107,137). Here: named per-stage wall timers collected per decode
(host parse / staging / launch / transfer / finalize) and a samples/s
gauge, plus `torch_trace`, a torch.profiler trace (the counterpart of
wvpk's XLA-level `xla_trace`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

_tls = threading.local()


def _sink() -> dict | None:
    return getattr(_tls, "sink", None)


@contextlib.contextmanager
def collect():
    """Collect stage timings for everything decoded in this context.

    Yields a dict {stage: seconds} that fills in as stages run.
    """
    prev = _sink()
    _tls.sink = defaultdict(float)
    try:
        yield _tls.sink
    finally:
        _tls.sink = prev


@contextlib.contextmanager
def stage(name: str):
    """Time a pipeline stage into the active collector (no-op otherwise)."""
    sink = _sink()
    if sink is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink[name] += time.perf_counter() - t0


def mark(name: str, t0: float) -> float:
    """Add elapsed-since-t0 seconds to the active collector (no-op
    otherwise) and return a fresh timestamp — the non-indenting
    alternative to `stage` for instrumenting straight-line stages."""
    now = time.perf_counter()
    sink = _sink()
    if sink is not None:
        sink[name] += now - t0
    return now


@contextlib.contextmanager
def torch_trace(log_dir: str, device="cuda"):
    """A torch.profiler trace of the block, written to `log_dir` as
    `torch_trace.json` (Chrome trace format: chrome://tracing, Perfetto):
    host activity, and the device's kernels and copies when `device` is a
    CUDA device. Yields the profiler (`key_averages()` for sums by
    name)."""
    import os

    import torch

    from .device import resolve

    acts = [torch.profiler.ProfilerActivity.CPU]
    if resolve(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "torch_trace.json"))


def format_report(sink: dict, total_samples: int | None = None) -> str:
    total = sum(sink.values())
    lines = ["stage timings:"]
    for name, secs in sorted(sink.items(), key=lambda kv: -kv[1]):
        pct = 100 * secs / total if total else 0
        lines.append(f"  {name:<12} {secs * 1000:9.1f} ms  {pct:5.1f}%")
    lines.append(f"  {'total':<12} {total * 1000:9.1f} ms")
    if total_samples and total > 0:
        lines.append(f"  throughput   {total_samples / total / 1e6:9.2f} Msamples/s")
    return "\n".join(lines)
