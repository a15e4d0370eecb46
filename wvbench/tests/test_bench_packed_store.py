"""packed_store_pct: the share of launched PCM lanes whose payload the
decorrelation kernel wrote packed (`launch#lanes`, `launch#packed_lanes`
through `run.stages`); nothing from a program without those counters."""

from __future__ import annotations

from types import SimpleNamespace

from wvbench import manifest
from wvbench.run import run_cell

from .conftest import tiny

SEED = 2**31 + 12345         # the seed of test_bench_run.py


def test_packed_store_share_reads_the_lane_counters():
    """The share over the window's lanes; nothing from a program without
    the counters (no `launch#lanes`), from a window that launched no lane,
    or from an encode run."""
    read = manifest.reader("packed_store_pct")
    assert "packed_store_pct" in {
        m["name"] for m in manifest.resolve("lossless.library").per_layer}

    def run(op="decode", **stages):
        return SimpleNamespace(op=op, calls=3, spans={}, trace=None,
                               stages={"launch": 0.2, **stages})

    assert read(run(**{"launch#lanes": 800,
                       "launch#packed_lanes": 800})) == 100.0
    assert read(run(**{"launch#lanes": 800,
                       "launch#packed_lanes": 200})) == 25.0
    assert read(run(**{"launch#lanes": 800,
                       "launch#packed_lanes": 0})) == 0.0
    assert read(run()) is None
    assert read(run(**{"launch#lanes": 0, "launch#packed_lanes": 0})) is None
    assert read(run("encode", **{"launch#lanes": 8,
                                 "launch#packed_lanes": 8})) is None


def test_traced_library_run_packs_every_lane():
    """A traced CPU run of the library cell (16-bit stereo lossless, every
    bucket on the packed route) reads packed_store_pct 100."""
    rc, result = run_cell(tiny("lossless.library"), SEED, 0.5, True,
                          device="cpu", guards=False, workers=2)
    assert rc == 0 and result["correct"], result
    assert result["metrics"]["packed_store_pct"]["value"] == 100.0
