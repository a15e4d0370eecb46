"""The per-layer metrics that read the program's own spans and counters
(`wvpk_torch/trace.py` through `run.stages`): a traced CPU run of each
cell reports them beside every metric it reported before, and each reads
nothing from a program that lacks its span."""

from __future__ import annotations

from types import SimpleNamespace

from wvbench import manifest
from wvbench.run import run_cell

from .conftest import tiny

SEED = 2**31 + 12345         # the seed of test_bench_run.py
NEW = {"lossless.library": ("parse_ms.program", "d2h_wait_ms", "d2h_gb_s",
                            "decode_sys_ms"),
       "lossless.encode": ("enc_wait_ms",)}
BEFORE = {"lossless.library": ("parse_ms", "staging_ms", "launch_ms",
                               "transfer_ms", "finalize_ms",
                               "decode_msamples_s.traced"),
          "lossless.encode": ("enc_stage_ms", "enc_assemble_ms")}


def _traced(cell):
    rc, result = run_cell(tiny(cell), SEED, 0.5, True, device="cpu",
                          guards=False, workers=2)
    assert rc == 0 and result["correct"], result
    return result["metrics"]


def test_traced_library_run_reports_the_program_spans():
    got = _traced("lossless.library")
    for name in ("parse_ms.program", "d2h_wait_ms", "decode_sys_ms"):
        assert got[name]["value"] >= 0
    # a CPU run copies nothing to the host: no rate
    assert "d2h_gb_s" not in got
    for name in BEFORE["lossless.library"]:
        assert got[name]["value"] > 0
    # the program's span lies inside the benchmark's span around it
    assert got["parse_ms.program"]["value"] <= got["parse_ms"]["value"]


def test_traced_encode_run_reports_the_device_waits():
    got = _traced("lossless.encode")
    assert got["enc_wait_ms"]["value"] >= 0
    for name in BEFORE["lossless.encode"]:
        assert got[name]["value"] > 0


def test_new_metrics_read_nothing_from_a_program_without_the_spans():
    """The parent program's stages (no child spans, no counters): every
    new reader returns None, on a run with a device trace too."""
    for cell, names in NEW.items():
        op = "decode" if cell == "lossless.library" else "encode"
        stages = ({"staging": 0.1, "launch": 0.1, "transfer": 0.1,
                   "finalize": 0.1} if op == "decode" else
                  {"enc_prep": 0.1, "enc_warm": 0.1, "enc_fetch": 0.1})
        run = SimpleNamespace(op=op, calls=2, stages=stages, spans={},
                              trace={"busy_s": 0.5, "window_s": 2.0,
                                     "kernel_s": 0.4})
        listed = {m["name"] for m in manifest.resolve(cell).per_layer}
        for name in names:
            assert name in listed
            assert manifest.reader(name)(run) is None, name


def test_new_metrics_read_the_program_counters():
    run = SimpleNamespace(
        op="decode", calls=4, spans={},
        trace={"busy_s": 0.5, "window_s": 2.0, "kernel_s": 0.4},
        stages={"parse": 0.4, "transfer.wait": 0.2, "transfer.copy": 0.5,
                "transfer.copy#bytes": 10**9, "decode#stime_us": 400_000})
    read = manifest.reader
    assert read("parse_ms.program")(run) == 100.0
    assert read("d2h_wait_ms")(run) == 50.0
    assert read("d2h_gb_s")(run) == 2.0
    assert read("decode_sys_ms")(run) == 100.0
    run = SimpleNamespace(op="encode", calls=2, spans={}, trace=None,
                          stages={"enc_warm.fetch": 0.1, "enc_fetch": 0.3})
    assert read("enc_wait_ms")(run) == 200.0
