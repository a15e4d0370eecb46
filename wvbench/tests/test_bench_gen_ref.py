"""The yardstick: the frozen generator and the frozen reference round-trip
each configuration's content to the source PCM, and neither imports the
program, jax or wvpk."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from wvbench import manifest
from wvbench.gen import synth
from wvbench.gen.encoder import encode_blocks
from wvbench.inputs import spec_of
from wvbench.ref.files import block_crc, block_spans, decode_alone

BENCH = os.path.join(manifest.ROOT, "wvbench")
CONFIGS = sorted(n[:-5] for n in os.listdir(os.path.join(BENCH, "configs")))


def _config(name):
    import json
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return dict(json.load(f), block_samples=2048)


@pytest.mark.parametrize("name", CONFIGS)
def test_generator_and_reference_round_trip(name):
    config = _config(name)
    pcm = synth.track(2**31 + 17, 2, 2048 * 3 + 500)   # a loud section
    assert pcm.dtype == np.int16 and pcm.shape == (6644, 2)
    assert np.abs(pcm.astype(np.int32)).max() > 1000
    wv = b"".join(encode_blocks(pcm, spec_of(config)))
    spans = block_spans(wv)
    assert [(i, n) for _s, _e, i, n in spans] == [
        (0, 2048), (2048, 2048), (4096, 2048), (6144, 500)]
    for s, e, start, n in spans:
        samples, crc_err, mute = decode_alone(wv[s:e])
        assert not crc_err and not mute
        assert np.array_equal(samples, pcm[start:start + n])
        crc = int.from_bytes(wv[s + 28:s + 32], "little")
        assert crc == block_crc(pcm[start:start + n])


def test_synthesis_is_fixed_by_the_seed():
    a = synth.track(12345678901, 0, 44100)
    b = synth.track(12345678901, 0, 44100)
    c = synth.track(12345678902, 0, 44100)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert not np.array_equal(synth.track(-5, 0, 4410),
                              synth.track(5, 0, 4410))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _modules(*dirs):
    for d in dirs:
        for dirpath, _dirs, names in os.walk(os.path.join(BENCH, d)):
            for n in names:
                if n.endswith(".py"):
                    yield os.path.join(dirpath, n)


@pytest.mark.parametrize("part", ["ref", "gen"])
def test_yardstick_imports_nothing_of_the_program(part):
    banned = {"jax", "jaxlib", "flax", "wvpk", "wvpk_torch", "torch"}
    for path in _modules(part):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & banned, (path, tops & banned)


def test_no_benchmark_module_imports_jax_or_wvpk():
    banned = {"jax", "jaxlib", "flax", "wvpk"}
    for path in _modules("."):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & banned, (path, tops & banned)


def test_yardstick_loads_no_program_module():
    code = (
        "import sys\n"
        "from wvbench.gen import synth\n"
        "from wvbench.gen.encoder import encode_blocks\n"
        "from wvbench.inputs import spec_of\n"
        "from wvbench.ref.files import block_spans, decode_alone\n"
        "import wvbench.check, wvbench.roofline\n"
        "cfg = dict(block_samples=512, joint_stereo=True, terms=[18, 17],\n"
        "           deltas=[2, 2], bits_per_sample=16, sample_rate=44100,\n"
        "           hybrid=False)\n"
        "pcm = synth.track(1, 0, 1000)\n"
        "wv = b''.join(encode_blocks(pcm, spec_of(cfg)))\n"
        "s, e, _, _ = block_spans(wv)[0]\n"
        "decode_alone(wv[s:e])\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "bad = tops & {'jax', 'jaxlib', 'flax', 'wvpk', 'wvpk_torch', 'torch'}\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                   check=True, timeout=300)


def test_zero_run_starting_on_channel_b_stays_lossless():
    """A quiet passage whose zero run starts on channel B right after a
    nonzero channel-A residual (block 23 of this segment): the program's
    copy of the encoder lost that residual's successor; the frozen copy
    reconstructs the run's first sample with it and stays lossless."""
    from wvbench.gen.encoder import EncodeSpec
    from wvbench.inputs import STREAM_CONTENT
    pcm = synth.track(1000002, (6 << 16) + 3, 1323000, stream=STREAM_CONTENT)
    pcm = pcm[:24 * 22050]
    spec = EncodeSpec(block_samples=22050, joint=True,
                      terms=(18, 18, 2, 17, 3), deltas=(2,) * 5)
    wv = b"".join(encode_blocks(pcm, spec))     # raises if not lossless
    s, e, start, n = block_spans(wv)[23]
    samples, crc_err, mute = decode_alone(wv[s:e])
    assert not crc_err and not mute
    assert np.array_equal(samples, pcm[start:start + n])
