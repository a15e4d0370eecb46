"""wvpk_torch vs wvpk through the whole lossless slice, on the CPU: the
staged buckets, decode_states, the api unpack and the CLI's .wav, on a
small mixed corpus (stereo and mono, 8/16/24/32-bit, several term chains,
shift, 5.1 multichannel and one corrupted block). Integer codec: every
comparison is exact."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from wvpk import api as jax_api
from wvpk import consts
from wvpk.cli import main as jax_cli_main
from wvpk.container import parse_blocks
from wvpk.engine import decode_states as jax_decode_states
from wvpk.engine.staging import group_blocks as jax_group_blocks
from wvpk.testgen import EncodeSpec, encode_dsd_file, encode_file, \
    encode_multichannel
from wvpk_torch import api
from wvpk_torch.cli import main as cli_main
from wvpk_torch.engine import decode_states
from wvpk_torch.engine.staging import group_blocks

from test_torch_cuda import lossless_case

REPO = Path(__file__).resolve().parents[1]


def noise(n, ch, scale, seed):
    return np.round(np.random.default_rng(seed).normal(0, scale, (n, ch))
                    ).astype(np.int64)


def _corrupted():
    data = bytearray(encode_file(noise(700, 2, 2000, 5),
                                 EncodeSpec(block_samples=350, joint=True)))
    data[200] ^= 0xFF
    return bytes(data)


CORPUS = {
    "stereo16_joint": lambda: encode_file(
        noise(1100, 2, 3000, 1), EncodeSpec(block_samples=512, joint=True)),
    "mono8": lambda: encode_file(
        np.clip(noise(600, 1, 30, 2), -128, 127),
        EncodeSpec(block_samples=256, mono=True, bytes_stored=1,
                   terms=(18, 2), deltas=(2, 1))),
    "stereo24_shift_cross_terms": lambda: encode_file(
        noise(600, 2, 20000, 3) << 3,
        EncodeSpec(block_samples=300, joint=True, bytes_stored=3, shift=3,
                   terms=(17, -1, 5, -2, 3, -3), deltas=(2, 3, 1, 2, 2, 4))),
    "int32_zeros": lambda: encode_file(
        noise(300, 2, 10**6, 4) << 5,
        EncodeSpec(block_samples=150, bytes_stored=4, int32_mode="zeros",
                   int32_zeros=5)),
    "mc51": lambda: encode_multichannel(
        noise(600, 6, 3000, 6), EncodeSpec(block_samples=300, joint=True)),
    "corrupted": _corrupted,
}


@pytest.fixture(scope="module")
def corpus():
    return {name: make() for name, make in CORPUS.items()}


def _all_states(corpus):
    return [b.state for data in corpus.values() for b in parse_blocks(data)]


def test_staging_matches_wvpk(corpus):
    states = _all_states(corpus)
    mine, theirs = group_blocks(states), jax_group_blocks(states)
    assert len(mine) == len(theirs) > 1
    fields = [f for f in mine[0].__dataclass_fields__
              if f not in ("profile", "states")]
    for a, b in zip(mine, theirs):
        assert a.profile.__dict__ == b.profile.__dict__
        for f in fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f)


def test_decode_states_matches_wvpk(corpus):
    states = _all_states(corpus)
    want = jax_decode_states(states)
    got = decode_states(states, device="cpu")
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w.samples, g.samples)
        assert (w.crc, w.crc_x, w.mute_error, w.crc_error) == \
            (g.crc, g.crc_x, g.mute_error, g.crc_error)
    assert sum(g.crc_error for g in got) == 1


def _unpack_all(mod, data, **kw):
    wpc = mod.WavpackOpenFileInput(data, flags=consts.OPEN_ALL_CHANNELS,
                                   **kw)
    n = mod.WavpackGetNumSamples(wpc)
    nch = mod.WavpackGetNumChannels(wpc)
    buf = np.zeros(n * nch, np.int32)
    got = mod.WavpackUnpackSamples(wpc, buf, n)
    return got, buf, mod.WavpackGetNumErrors(wpc), mod.WavpackGetMode(wpc)


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_api_unpack_matches_wvpk(corpus, name):
    want = _unpack_all(jax_api, corpus[name])
    got = _unpack_all(api, corpus[name], device="cpu")
    assert got[0] == want[0] > 0
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_cli_wav_matches_wvpk(corpus, name, tmp_path):
    src = tmp_path / f"{name}.wv"
    src.write_bytes(corpus[name])
    rc_want = jax_cli_main([str(src), "-o", str(tmp_path / "want.wav"),
                            "-q"])
    rc_got = cli_main([str(src), "-o", str(tmp_path / "got.wav"), "-q",
                       "--device", "cpu"])
    assert rc_got == rc_want == (1 if name == "corrupted" else 0)
    assert (tmp_path / "got.wav").read_bytes() == \
        (tmp_path / "want.wav").read_bytes()


@pytest.mark.parametrize("name", ["stereo16_joint", "mc51"])
def test_api_streaming_and_seek_match_eager(corpus, name, tmp_path):
    """Streaming open (lazy block parse) and SetSample seek decode the same
    samples as an eager open."""
    src = tmp_path / f"{name}.wv"
    src.write_bytes(corpus[name])
    _, eager, _, _ = _unpack_all(api, corpus[name], device="cpu")
    wpc = api.WavpackOpenFileInput(str(src), flags=consts.OPEN_ALL_CHANNELS,
                                   streaming=True, device="cpu")
    nch = api.WavpackGetNumChannels(wpc)
    assert api.SetSample(wpc, 377)
    buf = np.zeros(100 * nch, np.int32)
    assert api.WavpackUnpackSamples(wpc, buf, 100) == 100
    wpc.close()
    np.testing.assert_array_equal(buf, eager[377 * nch:477 * nch])


def test_cli_batch_matches_wvpk(corpus, tmp_path):
    paths = []
    for name in ("stereo16_joint", "mono8", "int32_zeros"):
        for tag in ("want", "got"):
            (tmp_path / tag).mkdir(exist_ok=True)
            (tmp_path / tag / f"{name}.wv").write_bytes(corpus[name])
        paths.append(name)
    assert jax_cli_main([str(tmp_path / "want" / f"{n}.wv") for n in paths]
                        + ["--batch", "-q"]) == 0
    assert cli_main([str(tmp_path / "got" / f"{n}.wv") for n in paths]
                    + ["--batch", "-q", "--device", "cpu"]) == 0
    for n in paths:
        assert (tmp_path / "got" / f"{n}.wav").read_bytes() == \
            (tmp_path / "want" / f"{n}.wav").read_bytes()


@pytest.mark.parametrize("seed", range(24))
def test_fuzz_lossless_matches_oracle(seed):
    """Random in-slice files: the port's decode equals the scalar oracle,
    flags included, and the source PCM wherever the block is intact."""
    from wvpk.ref import decode_block

    data, pcm, spec = lossless_case(seed)
    blocks = parse_blocks(data)
    got = decode_states([b.state for b in blocks], device="cpu")
    for blk, g in zip(blocks, got):
        want = decode_block(blk.state)
        np.testing.assert_array_equal(g.samples, want.samples,
                                      err_msg=f"seed {seed} {spec}")
        assert (g.mute_error, g.crc_error) == \
            (want.mute_error, want.crc_error), (seed, spec)
        if not (want.mute_error or want.crc_error):
            lo = blk.header.block_index
            src = pcm[lo:min(blk.header.end_index, len(pcm))]
            if spec.false_stereo:
                src = np.repeat(src, 2, axis=1)
            np.testing.assert_array_equal(g.samples, src)


OUT_OF_SLICE = {
    "hybrid": lambda: encode_file(
        noise(600, 2, 7000, 8),
        EncodeSpec(block_samples=300, joint=True, hybrid=True, bitrate=600)),
    "float": lambda: encode_file(
        np.random.default_rng(13).integers(-2**22, 2**22, size=(300, 2)),
        EncodeSpec(block_samples=150, float_data=True, bytes_stored=4,
                   float_shift=0, float_max_exp=127, float_norm_exp=127)),
    "int32_wvx": lambda: encode_file(
        np.random.default_rng(11).integers(-2**29, 2**29, size=(300, 2)),
        EncodeSpec(block_samples=150, bytes_stored=4, int32_mode="wvx",
                   int32_sent_bits=6)),
    "dsd": lambda: encode_dsd_file(
        np.random.default_rng(9).integers(0, 256, (400, 2)).astype(np.uint8),
        1, mono=False, block_samples=200),
}


@pytest.mark.parametrize("name", sorted(OUT_OF_SLICE))
def test_out_of_slice_profiles_raise(name):
    states = [b.state for b in parse_blocks(OUT_OF_SLICE[name]())]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode_states(states, device="cpu")


def test_cuda_without_gpu_raises(corpus):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: 'cuda' is a valid device here")
    states = [b.state for b in parse_blocks(corpus["stereo16_joint"])]
    with pytest.raises(RuntimeError, match="cuda"):
        decode_states(states, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        api.WavpackOpenFileInput(corpus["stereo16_joint"])


def test_port_imports_no_jax():
    code = ("import sys, wvpk_torch.api, wvpk_torch.cli, wvpk_torch.engine; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
