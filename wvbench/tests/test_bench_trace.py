"""The reduction of a profiler trace: device busy time, kernel time, the
busiest operations and the idle gaps labelled by the benchmark's spans;
the spans' mirrors on the device timeline are no device work."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from wvbench import tracing


class _Event:
    def __init__(self, name, on_device, start_us, dur_us):
        self._n, self._d, self._s, self._u = name, on_device, start_us, dur_us

    def name(self):
        return self._n

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._d else DeviceType.CPU

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._u * 1000)


def _prof(events):
    results = SimpleNamespace(events=lambda: [_Event(*e) for e in events])
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_reduce_counts_device_work_and_labels_gaps():
    prof = _prof([
        ("wvbench.window", False, 0, 1000),
        ("wvbench.parse", False, 0, 300),
        ("wvbench.decode_states", False, 300, 500),
        ("wvbench.decode_states", True, 300, 500),     # mirror: not work
        ("entropy_kernel", True, 400, 100),
        ("decorr_chain", True, 450, 100),              # overlaps: union
        ("Memcpy DtoH (Device -> Pageable)", True, 600, 100),
        ("wvbench.join", False, 800, 200),
        ("entropy_kernel", True, 2000, 50),            # after the window
    ])
    r = tracing.reduce(prof)
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx(250e-6)         # 400-650, 600-700
    assert r["kernel_s"] == pytest.approx(200e-6)       # copies left out
    assert r["device_ops"][0] == ["entropy_kernel", pytest.approx(100e-6)]
    names = [n for n, _ in r["device_ops"]]
    assert "wvbench.decode_states" not in names
    gaps = r["idle_gaps"]
    assert gaps[0] == ["wvbench.parse", pytest.approx(400e-6)]   # 0-400
    assert gaps[1] == ["wvbench.join", pytest.approx(300e-6)]    # 700-1000


def test_reduce_needs_the_window():
    with pytest.raises(RuntimeError):
        tracing.reduce(_prof([("entropy_kernel", True, 0, 10)]))


def test_kernel_seconds_sums_kernels_of_a_device_only_trace():
    prof = _prof([
        ("entropy_kernel", True, 400, 100),
        ("decorr_chain", True, 450, 100),              # overlaps: summed
        ("Memcpy DtoH (Device -> Pageable)", True, 600, 100),
        ("Memset (Device)", True, 700, 10),
        ("wvbench.decode_states", True, 300, 500),     # mirror: not work
    ])
    assert tracing.kernel_seconds(prof) == pytest.approx(200e-6)
    assert tracing.kernel_seconds(_prof([])) == 0
