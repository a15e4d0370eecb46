"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files; a cell, a mix and a metric added as new files are
picked up with no edit."""

from __future__ import annotations

import json
import os
import re
import shutil
from types import SimpleNamespace

import pytest

from wvbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest.load_manifest()


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["wvbench"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(M["command"]) <= 32
    for word in M["command"]:
        assert not word.startswith("/") and ".." not in word
    assert os.path.exists(os.path.join(manifest.ROOT, M["command"][1]))
    assert os.path.getsize(os.path.join(manifest.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024


def test_entries_keep_to_the_contract():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("wvbench/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) <= 16
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in M[k]]
    assert len(names) == len(set(names))
    for x in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
    for w in M["workloads"]:
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_resolves_and_reports_what_it_must(cell):
    c = manifest.resolve(cell)
    assert c.config["name"] and c.traffic["op"] in ("decode", "encode")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.reader(m["name"]))


def test_every_metric_reads_a_run_or_nothing():
    run = SimpleNamespace(op="decode", setup_s=1.0, window_s=2.0,
                          latencies=[0.1, 0.2], calls=2, frames=4_000_000,
                          bytes=10**9, stages={"staging": 0.1, "launch": 0.1,
                                               "transfer": 0.1,
                                               "finalize": 0.1},
                          spans={"parse": 0.1},
                          config={"sample_rate": 44100}, kernel_s=0.4,
                          trace={"busy_s": 0.5, "window_s": 2.0,
                                 "kernel_s": 0.4})
    for m in M["end_to_end"] + M["per_layer"]:
        value = manifest.reader(m["name"])(run)
        assert value is None or value >= 0


def test_added_cell_mix_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(manifest.ROOT, "wvbench"), root / "wvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads(json.dumps(M))
    (root / "wvbench" / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"op": "decode", "pool_files": 2, "files_per_call": 2,
         "seconds_min": 1, "seconds_max": 2, "warm_calls": 1,
         "kept_calls": 1}))
    (root / "wvbench" / "metrics" / "calls_seen.py").write_text(
        "def read(run):\n    return run.calls\n")
    m["workloads"].append({"name": "lossless.tiny", "config": "cd_lossless",
                           "traffic": "tiny_mix", "chips": 1, "why": "test"})
    m["per_layer"].append({"name": "calls_seen", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "benchmark",
                           "moves": "decode_gpu_ms_per_min",
                           "workloads": ["lossless.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = manifest.resolve("lossless.tiny", root=str(root))
    assert cell.traffic["name"] == "tiny_mix"
    assert cell.traffic["pool_files"] == 2
    assert cell.config["name"] == "cd_lossless"
    assert [x["name"] for x in cell.per_layer] == ["calls_seen"]
    read = manifest.reader("calls_seen", root=str(root))
    assert read(SimpleNamespace(calls=7)) == 7
    with pytest.raises(KeyError):
        manifest.resolve("no.such.cell", root=str(root))
