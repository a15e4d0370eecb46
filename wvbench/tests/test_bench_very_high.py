"""The very high cell (`cd_very_high`, `wavpack -hh`) and the metrics of
the decorrelation kernels: chain_kernel_pct (program counters),
decorr_ms_per_min and decorr_roofline (the device trace's busiest
operations); each reads nothing without its inputs."""

from __future__ import annotations

from types import SimpleNamespace

from wvbench import manifest
from wvbench.run import run_cell

from .conftest import tiny

SEED = 2**31 + 12345         # the seed of test_bench_run.py
NEW = ("chain_kernel_pct", "decorr_ms_per_min", "decorr_roofline")
CHAIN_OP = "void (anonymous namespace)::decorr_split<false, false, true>"
GENERIC_OP = "void (anonymous namespace)::decorr_generic<false, false, true>"


def test_very_high_cell_resolves():
    """very_high.library: the cd_very_high configuration (16 terms with
    their cross terms, 44,100-sample blocks as libwavpack sizes a -hh
    file's, lossless) under the library
    mix, on one chip, reporting the device time a minute of audio and the
    kernel metrics; the new metrics are reported by both library cells."""
    cell = manifest.resolve("very_high.library")
    assert cell.chips == 1 and cell.traffic["name"] == "library"
    c = cell.config
    assert c["name"] == "cd_very_high" and len(c["terms"]) == 16
    assert c["deltas"] == [2] * 16 and {-1, -2} <= set(c["terms"])
    assert (c["sample_rate"], c["channels"], c["bits_per_sample"],
            c["block_samples"]) == (44100, 2, 16, 44100)
    assert not (c["hybrid"] or c["wvc"] or c["md5"])
    assert "encode_options" not in c
    assert {m["name"] for m in cell.end_to_end} == {"decode_gpu_ms_per_min",
                                                    "setup_s"}
    for name in ("lossless.library", "very_high.library"):
        layer = {m["name"] for m in manifest.resolve(name).per_layer}
        assert set(NEW) | {"decode_roofline", "packed_store_pct"} <= layer
    assert not set(NEW) & {
        m["name"] for m in manifest.resolve("lossless.encode").per_layer}


def _run(op="decode", ops=None, frames=44100 * 60, unlisted=0.0,
         **stages):
    """A hand-made run; its trace's kernel_s is the listed kernels' time
    plus `unlisted`, the kernels below the busiest."""
    kernel_s = unlisted + sum(s for n, s in ops or ()
                              if not n.startswith("Memcpy"))
    return SimpleNamespace(
        op=op, calls=2, frames=frames, spans={}, kernel_s=kernel_s,
        stages={"launch": 0.2, **stages},
        config={"sample_rate": 44100, "channels": 2, "bits_per_sample": 16},
        trace=None if ops is None else {"busy_s": 1.0, "window_s": 2.0,
                                        "kernel_s": kernel_s,
                                        "device_ops": ops})


def test_chain_kernel_share_reads_the_lane_counters():
    read = manifest.reader("chain_kernel_pct")
    assert read(_run(**{"launch#lanes": 800,
                        "launch#chain_lanes": 800})) == 100.0
    assert read(_run(**{"launch#lanes": 800,
                        "launch#chain_lanes": 200})) == 25.0
    assert read(_run(**{"launch#lanes": 800, "launch#packed_lanes": 800})) \
        is None
    assert read(_run(**{"launch#lanes": 0, "launch#chain_lanes": 0})) is None
    assert read(_run("encode", **{"launch#lanes": 8,
                                  "launch#chain_lanes": 8})) is None


def test_decorr_time_metrics_read_the_busiest_device_ops():
    """decorr_ms_per_min and decorr_roofline sum every listed operation
    whose name holds `decorr_` (the split, chain and generic kernels) and
    nothing else: a minute of audio with 0.25 + 0.05 s of decorrelation
    reads 300 ms/min, and its 10,584,000 PCM bytes over 0.3 s read their
    share of the HBM peak; nothing without a trace, without such an
    operation, or for an encode run."""
    ops = [["void (anonymous namespace)::entropy_kernel<false, false, "
            "false>", 0.9], [CHAIN_OP, 0.25], [GENERIC_OP, 0.05],
           ["Memcpy DtoH (Device -> Pageable)", 2.0]]
    ms = manifest.reader("decorr_ms_per_min")
    roof = manifest.reader("decorr_roofline")
    assert abs(ms(_run(ops=ops)) - 300.0) < 1e-9
    want = 100.0 * (44100 * 60 * 2 * 2 / 3.35e12) / 0.3
    assert abs(roof(_run(ops=ops)) - want) < 1e-12
    for run in (_run(), _run(ops=ops[:1] + ops[3:]), _run(ops=[]),
                _run("encode", ops=ops), _run(ops=ops, frames=0)):
        assert ms(run) is None and roof(run) is None


def test_decorr_time_metrics_read_nothing_when_kernels_lie_below_the_list():
    """The trace lists only its busiest operations: where the kernels it
    leaves out (kernel_s less the listed kernels) could add more than 2 %
    to the decorrelation time read, a decorrelation kernel could be among
    them, and both metrics read nothing rather than low; at or under 2 %
    they read the listed time (0.25 s: up to 5 ms unlisted)."""
    ops = [["void (anonymous namespace)::entropy_kernel<false, false, "
            "false>", 0.9], [CHAIN_OP, 0.25],
           ["Memcpy DtoH (Device -> Pageable)", 2.0]]
    ms = manifest.reader("decorr_ms_per_min")
    roof = manifest.reader("decorr_roofline")
    assert abs(ms(_run(ops=ops, unlisted=0.004)) - 250.0) < 1e-9
    assert roof(_run(ops=ops, unlisted=0.004)) is not None
    over = _run(ops=ops, unlisted=0.006)
    assert ms(over) is None and roof(over) is None


def test_traced_very_high_run_reads_every_lane_on_the_chain_kernel():
    """A traced CPU run of the very high cell: correct, every lane routed
    to the compiled very high chain (chain_kernel_pct 100) and packed
    (packed_store_pct 100); no device trace here, so the device-time
    metrics read nothing."""
    rc, result = run_cell(tiny("very_high.library"), SEED, 0.5, True,
                          device="cpu", guards=False, workers=2)
    assert rc == 0 and result["correct"], result
    m = result["metrics"]
    assert m["chain_kernel_pct"]["value"] == 100.0
    assert m["packed_store_pct"]["value"] == 100.0
    assert "decorr_ms_per_min" not in m and "decorr_roofline" not in m
