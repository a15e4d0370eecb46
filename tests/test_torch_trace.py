"""wvpk_torch's span recorder (trace.py) on the CPU: the span tree (parents,
call ids, self time), counters summed as "<span>#<counter>" keys, nothing
recorded and no clock or getrusage read without a collector, the
`.items()` mapping the benchmark reads, the spans and byte counters of a
`decode_states` call and of an encode, the CLI's report, and the merged
`torch_trace.json`: the program's spans on the profiler's clock, on their
own track, never as profiler ranges."""

import json

import numpy as np
import pytest
import torch

from wvpk_torch import trace
from wvpk_torch.container import parse_blocks
from wvpk_torch.encode import encode_device
from wvpk_torch.engine import decode_states, dsd_pipeline, pipeline, staging
from wvpk_torch.testgen import EncodeSpec, encode_dsd_file, encode_file

TRANSFER = ("transfer.enqueue", "transfer.wait", "transfer.copy",
            "transfer.split")
PROBE = "probe."


def noise(n, ch, scale, seed):
    return np.round(np.random.default_rng(seed).normal(0, scale, (n, ch))
                    ).astype(np.int64)


def _lossless(n=64 * 6, seed=1):
    return encode_file(noise(n, 2, 3000, seed),
                       EncodeSpec(block_samples=64, joint=True))


def _states(data):
    return [b.state for b in parse_blocks(data)]


def _children(sink, i):
    return [s for s in sink.spans if s.parent == i]


def _busy(ms):
    t = trace.time.perf_counter()
    while trace.time.perf_counter() - t < ms / 1e3:
        pass


def test_span_tree_parents_call_ids_and_self_time():
    with trace.collect() as sink:
        for _ in range(2):
            with trace.stage("root"):
                _busy(1)
                with trace.stage("a"):
                    _busy(1)
                    with trace.stage("a.inner"):
                        _busy(1)
                with trace.stage("b"):
                    _busy(1)
    names = [(s.name, s.parent, s.call) for s in sink.spans]
    assert names == [("root", -1, 0), ("a", 0, 0), ("a.inner", 1, 0),
                     ("b", 0, 0), ("root", -1, 1), ("a", 4, 1),
                     ("a.inner", 5, 1), ("b", 4, 1)]
    for i, s in enumerate(sink.spans):
        kids = _children(sink, i)
        for k in kids:
            assert s.start_ns <= k.start_ns <= k.end_ns <= s.end_ns
        assert s.self_ns == (s.end_ns - s.start_ns
                             - sum(k.end_ns - k.start_ns for k in kids))
        assert s.self_ns >= 0.9e6          # each level busies 1 ms itself
    # a parent sums its whole interval; names sum over their spans
    for name in ("root", "a", "a.inner", "b"):
        assert sink[name] == pytest.approx(sum(
            (s.end_ns - s.start_ns) / 1e9 for s in sink.spans
            if s.name == name), rel=1e-12)
    assert sink["root"] >= sink["a"] + sink["b"]
    # on the Unix-epoch clock
    assert abs(sink.spans[0].start_ns - trace.time.time_ns()) < 60e9


def test_span_inside_a_span_of_its_name_is_that_span():
    with trace.collect() as sink:
        with trace.stage("encode"):
            with trace.stage("encode"):
                trace.count("n", 2)
                with trace.stage("x"):
                    pass
    assert [(s.name, s.parent) for s in sink.spans] == [("encode", -1),
                                                         ("x", 0)]
    assert sink["encode#n"] == 2


def test_counters_sum_as_hash_keys():
    with trace.collect() as sink:
        trace.count("outside", 5)           # no open span: counts nowhere
        for n in (3, 4):
            with trace.stage("s"):
                trace.count("bytes", n)
                with trace.stage("t"):
                    trace.count("bytes", 10 * n)
                trace.count("bytes", 1)
    assert sink["s#bytes"] == 3 + 1 + 4 + 1
    assert sink["t#bytes"] == 70
    assert [s.counters["bytes"] for s in sink.spans] == [4, 30, 5, 40]
    assert all(s.counters["stime_us"] >= 0 for s in sink.spans)
    assert sink["s#stime_us"] == sum(s.counters["stime_us"]
                                     for s in sink.spans if s.name == "s")
    assert not any(k.startswith("outside") or k == "#outside" for k in sink)
    assert {k for k in sink if "#" not in k} == {"s", "t"}


def test_no_records_clock_or_getrusage_without_a_collector(monkeypatch):
    class Refuse:
        def __getattr__(self, name):
            raise AssertionError(f"read {name} without a collector")

    monkeypatch.setattr(trace, "resource", Refuse())
    monkeypatch.setattr(trace, "time", Refuse())
    data = _lossless()
    with trace.stage("s"):
        trace.count("n", 1)
    blocks = decode_states(_states(data), "cpu")
    encode_device(noise(512, 2, 3000, 3), device="cpu", block_samples=256)
    assert not trace.active() and len(blocks) == 6
    monkeypatch.undo()
    with trace.collect() as sink:
        pass
    assert sink == {} and sink.spans == []


@pytest.fixture
def decoded():
    """One CPU decode_states call (its blocks parsed inside the
    collector), with the bytes each host-to-device copy staged and the
    host arrays of each device-to-host copy."""
    staged, fetched = [], []
    data = _lossless() + encode_file(
        noise(64 * 3, 1, 700, 2),
        EncodeSpec(block_samples=64, mono=True, terms=(17, 2),
                   deltas=(2, 2)))
    with trace.collect() as sink:
        states = _states(data)
        mp = pytest.MonkeyPatch()
        try:
            def counted(arr, device, _to=staging.to_device):
                staged.append(arr.nbytes)
                return _to(arr, device)

            def fetch(handle, _finish=pipeline._finish_fetch):
                out = _finish(handle)
                fetched.append(sum(a.nbytes for a in out))
                return out

            mp.setattr(staging, "to_device", counted)
            mp.setattr(pipeline, "_finish_fetch", fetch)
            blocks = decode_states(states, "cpu")
        finally:
            mp.undo()
    return sink, states, blocks, staged, fetched


def test_decode_yields_its_spans(decoded):
    sink, states, blocks, _, _ = decoded
    tree = [(s.name, sink.spans[s.parent].name if s.parent >= 0 else None)
            for s in sink.spans]
    assert tree == [("parse", None), ("decode", None), ("staging", "decode"),
                    ("launch", "decode"), ("transfer", "decode"),
                    ("transfer.enqueue", "transfer"), ("transfer", "decode"),
                    ("transfer.wait", "transfer"),
                    ("transfer.copy", "transfer"),
                    ("transfer.split", "transfer"), ("finalize", "decode")]
    assert [s.call for s in sink.spans] == [0] + [1] * 10
    assert sink["transfer"] >= sum(sink[k] for k in TRANSFER)
    assert sink["decode"] >= sum(sink[k] for k in (
        "staging", "launch", "transfer", "finalize"))
    assert sink["decode#blocks"] == len(states) == len(blocks) == 9
    assert (sink["decode#buckets"], sink["decode#chunks"]) == (2, 1)
    assert (sink["parse#blocks"], sink["parse#python_blocks"]) == (9, 0)


def test_items_mapping_keeps_the_stage_names(decoded):
    """The names the benchmark's readers sum keep their meaning: seconds,
    floats, each name once, every counter apart under a '#' key."""
    sink = decoded[0]
    for name in ("staging", "launch", "transfer", "finalize", "parse"):
        assert isinstance(sink[name], float) and sink[name] > 0
    seconds = {k for k, _ in sink.items() if "#" not in k}
    assert seconds == {"parse", "decode", "staging", "launch", "transfer",
                       "finalize", *TRANSFER}
    assert all(isinstance(v, int) for k, v in sink.items() if "#" in k)
    with trace.collect() as enc:
        encode_device(noise(1024, 2, 3000, 4), device="cpu",
                      block_samples=256)
    assert {k for k in enc if "#" not in k} == {
        "encode", "enc_prep", "enc_warm", "enc_warm.fetch", "enc_meta",
        "enc_scan", "enc_fetch", "enc_pack", "enc_assemble"}
    spans = {s.name: s for s in enc.spans}
    assert spans["enc_warm.fetch"].parent == enc.spans.index(
        spans["enc_warm"])
    assert all(s.parent == 0 for s in enc.spans[1:]
               if s.name != "enc_warm.fetch")


def test_byte_counters_equal_the_staged_and_fetched_bytes(decoded):
    sink, _, _, staged, fetched = decoded
    assert len(staged) == 2 and len(fetched) == 1
    assert sink["launch#h2d_bytes"] == sum(staged)
    assert sink["transfer.copy#bytes"] == fetched[0]


class _Event:
    """A stand-in for a CUDA event: notes when it is waited on, on the
    collector's clock."""

    def __init__(self, sink):
        self.sink, self.at = sink, None

    def synchronize(self):
        self.at = trace.time.perf_counter_ns() + self.sink.anchor_ns


def _span_at(sink, t_ns):
    """The innermost span open at `t_ns`."""
    return [s for s in sink.spans if s.start_ns <= t_ns <= s.end_ns][-1]


def test_each_fetch_path_fills_its_spans():
    """A copy made at the fetch lies in `transfer.copy` with its
    `#bytes`; an overlapped copy (chunked delivery on a card: a pinned
    blob between a `ready` and a `done` event) is waited for on `ready`
    in `transfer.wait` and on `done` in `transfer.copy`, which counts no
    bytes: they count where the copy is queued."""
    arrs = [torch.arange(6, dtype=torch.int32).reshape(2, 3),
            torch.arange(4, dtype=torch.int32)]
    with trace.collect() as sink:
        with trace.stage("transfer"):
            made = pipeline._finish_fetch(pipeline._start_fetch(arrs))
    assert sink["transfer.copy#bytes"] == 40
    assert not any(k.startswith("transfer.enqueue#b") for k in sink)
    with trace.collect() as sink:
        ready, done = _Event(sink), _Event(sink)
        handle = ([(torch.cat([a.reshape(-1) for a in arrs]),
                    (ready, done), [0, 1])], [(2, 3), (4,)])
        with trace.stage("transfer"):
            overlapped = pipeline._finish_fetch(handle)
    assert _span_at(sink, ready.at).name == "transfer.wait"
    assert _span_at(sink, done.at).name == "transfer.copy"
    assert ready.at < done.at
    assert not any(k.endswith("#bytes") for k in sink)
    assert [s.name for s in sink.spans] == ["transfer", *TRANSFER[1:]]
    for a, b, w in zip(made, overlapped, arrs):
        np.testing.assert_array_equal(a, w.numpy())
        np.testing.assert_array_equal(b, w.numpy())


def test_dsd_staging_apart_from_launch(monkeypatch):
    """A DSD call stages its groups under `staging`, beside (not inside)
    `launch`, whose h2d count holds the groups' bytes; a DSD block leaves
    the native walker for the Python path."""
    seen = []

    def counted(arr, device, _to=dsd_pipeline.to_device):
        seen.append(arr.nbytes)
        return _to(arr, device)

    monkeypatch.setattr(dsd_pipeline, "to_device", counted)
    rng = np.random.default_rng(5)
    data = encode_dsd_file(rng.integers(0, 256, (64 * 3, 2)), 1,
                           history_bits=2, block_samples=64)
    with trace.collect() as sink:
        decode_states(_states(data), "cpu")
    names = [(s.name, s.parent) for s in sink.spans]
    assert names[:4] == [("parse", -1), ("decode", -1), ("staging", 1),
                         ("launch", 1)]
    assert sink["parse#python_blocks"] == sink["parse#blocks"] == 3
    assert sink["launch#h2d_bytes"] == sum(seen) > 0


def test_report_prints_the_tree_and_counters_apart(decoded):
    sink = decoded[0]
    report = trace.format_report(sink, 64 * 9)
    lines = report.splitlines()
    total_ms = (sink["parse"] + sink["decode"]) * 1e3
    total = next(x for x in lines if x.strip().startswith("total"))
    assert float(total.split()[1]) == pytest.approx(total_ms, abs=0.06)
    assert any(x.strip().startswith("throughput") for x in lines)
    depth = {x.strip().split()[0]: len(x) - len(x.lstrip())
             for x in lines[1:lines.index("counters:")]}
    assert depth["transfer.copy"] > depth["transfer"] > depth["decode"]
    assert depth["parse"] == depth["decode"]
    counters = lines[lines.index("counters:") + 1:]
    assert any("transfer.copy#bytes" in x for x in counters)
    assert not any("#" in x for x in lines[:lines.index("counters:")])


def _trace(tmp_path, states, monkeypatch=None):
    """A torch_trace (CPU activity) over one decode_states call; with
    `monkeypatch`, every program span also opens a profiler range
    "probe.<name>" inside its interval, for the profiler's own account of
    which ops ran inside it. Returns the merged trace's events."""
    if monkeypatch is not None:
        enter, leave = trace.Collector._enter, trace.Collector._exit
        ranges = {}

        def probed_enter(self, name):
            span = enter(self, name)
            if span is not None:
                ranges[id(span)] = torch.profiler.record_function(
                    PROBE + name)
                ranges[id(span)].__enter__()
            return span

        def probed_exit(self, span):
            ranges.pop(id(span)).__exit__(None, None, None)
            leave(self, span)

        monkeypatch.setattr(trace.Collector, "_enter", probed_enter)
        monkeypatch.setattr(trace.Collector, "_exit", probed_exit)
    with trace.torch_trace(str(tmp_path), device="cpu"):
        decode_states(states, "cpu")
    return json.loads((tmp_path / "torch_trace.json").read_text())[
        "traceEvents"]


def _within(inner, outer, tol_us):
    return (outer["ts"] - tol_us <= inner["ts"]
            and inner["ts"] + inner["dur"]
            <= outer["ts"] + outer["dur"] + tol_us)


def test_profiler_ops_lie_within_their_spans(tmp_path, monkeypatch):
    """Every aten:: op the profiler saw inside a span's probe range lies
    within that span's interval in the merged trace, to 0.2 ms."""
    events = _trace(tmp_path, _states(_lossless()), monkeypatch)
    spans = [e for e in events if e.get("cat") == "wvpk_torch"]
    probes = [e for e in events if e.get("ph") == "X"
              and e["name"].startswith(PROBE)]
    assert len(spans) == len(probes) == 10
    by_name: dict[str, list] = {}
    for e in sorted(spans, key=lambda e: e["args"]["span"]):
        by_name.setdefault(e["name"], []).append(e)
    pairs = []
    for name, group in by_name.items():
        mine = sorted((p for p in probes if p["name"] == PROBE + name),
                      key=lambda p: p["ts"])
        assert len(mine) == len(group)
        pairs += zip(mine, group)
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]
    checked = set()
    for probe, span in pairs:
        assert _within(probe, span, 200)
        for i, op in enumerate(ops):
            if op["tid"] == probe["tid"] and _within(op, probe, 0):
                assert _within(op, span, 200), (op, span)
                checked.add(i)
    assert len(checked) > 20
    assert {s["name"] for p, s in pairs for op in ops
            if _within(op, p, 0)} >= {"launch", "transfer.enqueue"}


def test_torch_trace_holds_no_profiler_range_of_a_program_span(tmp_path):
    events = _trace(tmp_path, _states(_lossless()))
    mine = [e for e in events if e.get("cat") == "wvpk_torch"]
    names = {e["name"] for e in mine}
    assert names == {"decode", "staging", "launch", "transfer",
                     "finalize", *TRANSFER}
    assert {e["pid"] for e in mine} == {trace.TRACK}
    assert all({"call", "parent", "span", "stime_us"} <= set(e["args"])
               for e in mine)
    others = [e for e in events if e.get("cat") != "wvpk_torch"]
    assert others and not [e for e in others if e.get("name") in names]
    assert not [e for e in others
                if str(e.get("name", "")).startswith(PROBE)]
