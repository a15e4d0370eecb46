"""Tracing / profiling (SURVEY.md section 5.1).

The reference's only instrumentation is a Stopwatch around the decode loop
(WvDemo.cs:107,137). Here: the port's one span recorder, and `torch_trace`,
a torch.profiler trace (the counterpart of wvpk's XLA-level `xla_trace`).

While a `collect()` is active on the thread, each `stage(name)` keeps a
`Span`: its name, its start and end on the Unix-epoch clock in ns (the
clock torch.profiler's events use), the index of the span it sits in, its
call id and its counters. A span with no enclosing span is a root and
opens a new call id: `decode` (engine.run_decode), `parse`
(container.parse_blocks) and `encode` (encode.encode_device,
engine.device_encoder.encode_blocks_device). A span opened inside a span
of the same name is that span. `count(name, n)` adds to the innermost
open span's counter; every span also counts `stime_us`, the calling
thread's system CPU time over it in us (the kernel's share of the span:
page faults of fresh host memory, syscalls). With no collector a span or
a count costs one thread-local lookup: no clock, no getrusage, no
allocation.
"""

from __future__ import annotations

import contextlib
import resource
import threading
import time

_tls = threading.local()

TRACK = "wvpk_torch"     # the program's track in a torch_trace


def _sink() -> Collector | None:
    return getattr(_tls, "sink", None)


def _stime_us() -> int:
    return int(resource.getrusage(resource.RUSAGE_THREAD).ru_stime * 1e6)


class Span:
    """One span: `start_ns` / `end_ns` on the Unix-epoch clock, `parent`
    the index of the enclosing span in `Collector.spans` (-1 for a root),
    `call` the call id, `counters` its counts, `child_ns` the time its
    child spans cover."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "call", "counters",
                 "child_ns", "_stime0")

    def __init__(self, name, parent, call):
        self.name = name
        self.parent = parent
        self.call = call
        self.counters: dict[str, int] = {}
        self.child_ns = 0

    @property
    def self_ns(self) -> int:
        """The span's duration less its children's."""
        return self.end_ns - self.start_ns - self.child_ns


class Collector(dict):
    """What `collect()` yields: name -> seconds summed over every span of
    that name (a parent sums its whole interval), and "<span>#<counter>"
    -> the counter summed over those spans. `.spans` holds the records in
    the order they opened; `.seconds()` the mapping without counters."""

    def __init__(self):
        super().__init__()
        self.spans: list[Span] = []
        self.anchor_ns = time.time_ns() - time.perf_counter_ns()
        self._open: list[int] = []
        self._calls = 0

    def seconds(self) -> dict[str, float]:
        """name -> seconds alone, without the counters."""
        return {k: v for k, v in self.items() if "#" not in k}

    def _enter(self, name: str) -> Span | None:
        if self._open and self.spans[self._open[-1]].name == name:
            return None
        if self._open:
            parent = self._open[-1]
            call = self.spans[parent].call
        else:
            parent, call = -1, self._calls
            self._calls += 1
        span = Span(name, parent, call)
        self._open.append(len(self.spans))
        self.spans.append(span)
        span._stime0 = _stime_us()
        span.start_ns = span.end_ns = time.perf_counter_ns() + self.anchor_ns
        return span

    def _exit(self, span: Span) -> None:
        span.end_ns = time.perf_counter_ns() + self.anchor_ns
        self._open.pop()
        dur = span.end_ns - span.start_ns
        if span.parent >= 0:
            self.spans[span.parent].child_ns += dur
        self[span.name] = self.get(span.name, 0.0) + dur / 1e9
        self._add(span, "stime_us", _stime_us() - span._stime0)

    def _add(self, span: Span, counter: str, n: int) -> None:
        span.counters[counter] = span.counters.get(counter, 0) + n
        key = f"{span.name}#{counter}"
        self[key] = self.get(key, 0) + n


@contextlib.contextmanager
def collect():
    """Collect the spans of everything this thread runs in the context.
    Yields a `Collector` that fills in as spans close."""
    prev = _sink()
    _tls.sink = Collector()
    try:
        yield _tls.sink
    finally:
        _tls.sink = prev


def active() -> bool:
    """Whether a collector is active on this thread."""
    return _sink() is not None


@contextlib.contextmanager
def stage(name: str):
    """A span of the active collector (no-op otherwise); also a function
    decorator."""
    sink = _sink()
    if sink is None:
        yield
        return
    span = sink._enter(name)
    try:
        yield
    finally:
        if span is not None:
            sink._exit(span)


def count(counter: str, n: int) -> None:
    """Add `n` to `counter` of the innermost open span (no-op without a
    collector or an open span)."""
    sink = _sink()
    if sink is not None and sink._open:
        sink._add(sink.spans[sink._open[-1]], counter, int(n))


def _chrome_events(sink: Collector, base_ns: int = 0) -> list[dict]:
    """The spans as Chrome-trace complete events on a track of their own
    (process `TRACK`, as torch's own "Spans" track), `ts` in us from
    `base_ns`; `args` holds the call id, the parent's index, the span's
    own index, its self time in us and its counters."""
    return [{"ph": "X", "cat": "wvpk_torch", "name": s.name, "pid": TRACK,
             "tid": "spans", "ts": (s.start_ns - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"call": s.call, "parent": s.parent, "span": i,
                      "self_us": s.self_ns / 1e3, **s.counters}}
            for i, s in enumerate(sink.spans)]


@contextlib.contextmanager
def torch_trace(log_dir: str, device="cuda"):
    """A torch.profiler trace of the block, written to `log_dir` as
    `torch_trace.json` (Chrome trace format: chrome://tracing, Perfetto):
    host activity, the device's kernels and copies when `device` is a
    CUDA device, and the program's spans (a collector runs with the
    profiler) as complete events on their own track, on the profiler's
    clock. Yields the profiler (`key_averages()` for sums by name)."""
    import json
    import os

    import torch

    from .device import resolve

    acts = [torch.profiler.ProfilerActivity.CPU]
    if resolve(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof, collect() as sink:
        yield prof
    path = os.path.join(log_dir, "torch_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    # torch writes ts in us from baseTimeNanoseconds (absolute where absent)
    data["traceEvents"] += _chrome_events(
        sink, int(data.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(data, f)


def format_report(sink: Collector, total_samples: int | None = None) -> str:
    """The span tree (spans of one name under one path merged): total
    and self time, the share of the root spans' time and how many spans;
    the throughput over the root spans' time; then the counters."""
    rows: dict[tuple, list] = {}
    paths: list[tuple] = []
    for s in sink.spans:
        path = (paths[s.parent] if s.parent >= 0 else ()) + (s.name,)
        paths.append(path)
        row = rows.setdefault(path, [0, 0, 0])
        row[0] += s.end_ns - s.start_ns
        row[1] += s.self_ns
        row[2] += 1
    total = sum(r[0] for p, r in rows.items() if len(p) == 1) / 1e9
    lines = ["stage timings (total, self):"]

    def tree(prefix):       # depth first, each level in order of first use
        for path in rows:
            if path[:-1] == prefix:
                yield path
                yield from tree(path)

    for path in tree(()):
        tot, own, n = rows[path]
        pct = 100 * tot / 1e9 / total if total else 0
        label = "  " * len(path) + path[-1]
        lines.append(f"{label:<22} {tot / 1e6:9.1f} ms {own / 1e6:9.1f} ms"
                     f"  {pct:5.1f}%  x{n}")
    lines.append(f"  {'total':<20} {total * 1000:9.1f} ms")
    if total_samples and total > 0:
        lines.append(f"  {'throughput':<20} "
                     f"{total_samples / total / 1e6:9.2f} Msamples/s")
    counters = sorted((k, v) for k, v in sink.items() if "#" in k)
    if counters:
        lines.append("counters:")
        lines += [f"  {k:<28} {v:>14,}" for k, v in counters]
    return "\n".join(lines)
