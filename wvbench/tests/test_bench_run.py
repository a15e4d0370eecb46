"""A whole run at a CPU size with the device checks off: sound runs come
out correct, the control and each fault a cell can have come out not
correct, and the command refuses without a card or without the program.
The card test runs each cell by its command, untraced and traced."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from wvbench import manifest
from wvbench.run import banned_modules, run_cell

from .conftest import tiny

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]
SEED = 2**31 + 12345


def _run(cell_name, **kw):
    rc, result = run_cell(tiny(cell_name), SEED, 0.5, kw.pop("trace", False),
                          device="cpu", guards=False, workers=2, **kw)
    assert rc == 0
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0
    # a CPU run has no device trace to read
    assert set(result["metrics"]) == {
        m["name"] for m in manifest.resolve(cell).end_to_end
        if m["source"] == "host_clock"}
    assert not banned_modules()


def test_traced_run_reports_program_spans():
    result = _run("lossless.library", trace=True)
    assert result["correct"]
    for name in ("parse_ms", "staging_ms", "launch_ms", "finalize_ms",
                 "transfer_ms", "decode_msamples_s.traced"):
        assert result["metrics"][name]["value"] > 0
    assert "window_s" in result["device"] and "breakdown" in result


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(cell):
    result = _run(cell, control=True)
    assert not result["correct"], result["checks"]


def _drop_half(decode_states):
    def broken(states, device):
        res = decode_states(states, device)
        return res[:len(res) // 2]
    return broken


def _alter_one_sample(decode_states):
    def broken(states, device):
        res = decode_states(states, device)
        for r in res:
            r.samples = r.samples.copy()
            r.samples[0, 0] += 1
        return res
    return broken


@pytest.mark.parametrize("fault", [_drop_half, _alter_one_sample])
def test_decode_faults_come_out_not_correct(fault, monkeypatch):
    import wvpk_torch.engine as engine
    monkeypatch.setattr(engine, "decode_states", fault(engine.decode_states))
    result = _run("lossless.library")
    assert not result["correct"], result["checks"]


def _blocks(wv):
    from wvbench.ref.files import block_spans
    return [wv[s:e] for s, e, _, _ in block_spans(wv)]


def _encode_drop_half(encode_device):
    def broken(pcm, **kw):
        blocks = _blocks(encode_device(pcm, **kw))
        return b"".join(blocks[:max(1, len(blocks) // 2)])
    return broken


def _encode_alter_payload(encode_device):
    def broken(pcm, **kw):
        out = []
        for b in _blocks(encode_device(pcm, **kw)):
            b = bytearray(b)
            b[-3] ^= 0x5A            # inside the bitstream, the last item
            out.append(bytes(b))
        return b"".join(out)
    return broken


def _encode_alter_one_block(encode_device):
    """A payload byte altered in one block of each stream, its header's
    CRC (the program's, from its input) left as it was."""
    def broken(pcm, **kw):
        blocks = _blocks(encode_device(pcm, **kw))
        b = bytearray(blocks[len(blocks) // 2])
        b[-3] ^= 0x5A
        blocks[len(blocks) // 2] = bytes(b)
        return b"".join(blocks)
    return broken


@pytest.mark.parametrize("fault", [_encode_drop_half, _encode_alter_payload,
                                   _encode_alter_one_block])
def test_encode_faults_come_out_not_correct(fault, monkeypatch):
    import wvpk_torch.encode as encode
    monkeypatch.setattr(encode, "encode_device", fault(encode.encode_device))
    result = _run("lossless.encode")
    assert not result["correct"], result["checks"]


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "wvbench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=manifest.ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "refused" in proc.stderr


def test_command_refuses_without_the_program(tmp_path):
    for name in ("BENCHMARK.json",):
        shutil.copy(os.path.join(manifest.ROOT, name), tmp_path / name)
    shutil.copytree(os.path.join(manifest.ROOT, "wvbench"),
                    tmp_path / "wvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "sys.argv = ['wvbench/run.py', '--workload', %r, '--seed', '1',"
            " '--seconds', '1', '--trace', '0']\n"
            "runpy.run_path('wvbench/run.py', run_name='__main__')\n"
            % CELLS[0])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "program is not in this checkout" in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for trace in ("0", "1"):
        proc = subprocess.run(
            [sys.executable, "wvbench/run.py", "--workload", cell, "--seed",
             str(SEED), "--seconds", "3", "--trace", trace],
            cwd=manifest.ROOT, capture_output=True, text=True, timeout=1200)
        assert proc.returncode == 0, proc.stderr[-2000:]
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        assert result["correct"], result["checks"]
        assert result["device"]["platform"] == "gpu"
        if trace == "0":
            assert set(result["metrics"]) == {
                m["name"] for m in manifest.resolve(cell).end_to_end}
        if trace == "1":
            assert result["device"]["busy_s"] > 0
