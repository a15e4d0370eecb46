"""wvpk_torch vs wvpk through every PCM mode, on the CPU: the staged
buckets, decode_states, the api unpack and the CLI's .wav, on a small mixed
corpus (stereo and mono, 8/16/24/32-bit, several term chains, shift, 5.1
multichannel, one corrupted block, hybrid with and without bitrate and
balance, float, int32+wvx with false stereo, a hybrid file with its .wvc).
Integer codec: every comparison is exact. The faults of the reference that
the port does not copy are checked against the source or by what the
port does, not against wvpk."""

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
from wvpk.container.blocks import pair_wvc
from wvpk.engine import decode_states as jax_decode_states
from wvpk.engine.staging import group_blocks as jax_group_blocks
from wvpk.testgen import EncodeSpec, encode_dsd_file, encode_file, \
    encode_multichannel
from wvpk.testgen.encoder import encode_blocks
from wvpk_torch import api
from wvpk_torch.cli import main as cli_main
from wvpk_torch.engine import decode_states, pipeline
from wvpk_torch.engine.staging import group_blocks

from test_torch_cuda import lossless_case, pcm_case

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
    "hybrid": lambda: encode_file(
        noise(600, 2, 7000, 8),
        EncodeSpec(block_samples=300, joint=True, hybrid=True, bitrate=600)),
    "hybrid_bitrate_balance": lambda: encode_file(
        noise(512, 2, 3000, 9),
        EncodeSpec(block_samples=256, joint=True, hybrid=True,
                   hybrid_bitrate=True, hybrid_balance=True, bitrate=350,
                   bitrate_delta=2)),
    "hybrid_mono": lambda: encode_file(
        noise(400, 1, 3000, 10),
        EncodeSpec(block_samples=256, mono=True, hybrid=True,
                   hybrid_bitrate=True, bitrate=300, bitrate_delta=1)),
    "float": lambda: encode_file(
        np.random.default_rng(13).integers(-2**22, 2**22, size=(300, 2)),
        EncodeSpec(block_samples=150, float_data=True, bytes_stored=4,
                   float_shift=0, float_max_exp=127, float_norm_exp=127)),
    "int32_wvx_false_stereo": lambda: encode_file(
        np.random.default_rng(11).integers(-2**29, 2**29, size=(300, 1)),
        EncodeSpec(block_samples=150, bytes_stored=4, false_stereo=True,
                   int32_mode="wvx", int32_sent_bits=6)),
    "hybrid_wvc": lambda: _wvc_pair(noise(512, 2, 4000, 12), EncodeSpec(
        block_samples=256, joint=True, hybrid=True, hybrid_bitrate=True,
        bitrate=300, bitrate_delta=1, wvc=True)),
}


def _wvc_pair(pcm, spec):
    """(.wv bytes, .wvc bytes) of a hybrid-lossless encode."""
    sink = []
    wv = b"".join(encode_blocks(pcm, spec, wvc_sink=sink))
    return wv, b"".join(sink)


def _blocks(entry):
    """Parsed blocks of a corpus entry, its .wvc paired where it has one."""
    if isinstance(entry, tuple):
        blocks = parse_blocks(entry[0])
        assert pair_wvc(blocks, entry[1]) == len(blocks)
        return blocks
    return parse_blocks(entry)


@pytest.fixture(scope="module")
def corpus():
    return {name: make() for name, make in CORPUS.items()}


def _all_states(corpus):
    return [b.state for entry in corpus.values() for b in _blocks(entry)]


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
        assert (w.crc, w.crc_x, w.crc_wvc, w.mute_error, w.crc_error,
                w.wvc_applied) == (g.crc, g.crc_x, g.crc_wvc, g.mute_error,
                                   g.crc_error, g.wvc_applied)
    assert sum(g.crc_error for g in got) == 1
    assert any(g.wvc_applied for g in got)
    assert any(g.crc_x != -1 for g in got)


def _unpack_all(mod, entry, **kw):
    data, wvc = entry if isinstance(entry, tuple) else (entry, None)
    wpc = mod.WavpackOpenFileInput(data, flags=consts.OPEN_ALL_CHANNELS,
                                   wvc_source=wvc, **kw)
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
    """A .wvc beside its .wv is picked up by both CLIs."""
    src = tmp_path / f"{name}.wv"
    entry = corpus[name]
    if isinstance(entry, tuple):
        entry, wvc = entry
        (tmp_path / f"{name}.wvc").write_bytes(wvc)
    src.write_bytes(entry)
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
    for name in ("stereo16_joint", "mono8", "int32_zeros", "float",
                 "hybrid_mono"):
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


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_every_pcm_family_matches_oracle(seed):
    """Random files of every PCM family (plain, hybrid, int32 with wvx or
    zeros/ones/dups, float) and random .wvc pairs: the port's decode
    equals the scalar oracle, flags included, and the source PCM wherever
    the decode is lossless and the block intact."""
    from wvpk.ref import decode_block

    blocks, pcm, spec = pcm_case(seed)
    got = decode_states([b.state for b in blocks], device="cpu")
    lossless = (not spec.hybrid or spec.wvc) and not spec.float_data
    for blk, g in zip(blocks, got):
        want = decode_block(blk.state)
        np.testing.assert_array_equal(g.samples, want.samples,
                                      err_msg=f"seed {seed} {spec}")
        assert (g.mute_error, g.crc_error, g.crc_wvc, g.wvc_applied) == \
            (want.mute_error, want.crc_error, want.crc_wvc,
             want.wvc_applied), (seed, spec)
        if lossless and not (want.mute_error or want.crc_error):
            lo = blk.header.block_index
            src = pcm[lo:min(blk.header.end_index, len(pcm))]
            if spec.false_stereo:
                src = np.repeat(src, 2, axis=1)
            np.testing.assert_array_equal(g.samples, src)


def test_float_bucket_is_never_packed():
    """The float restore yields 24-bit values whatever the stored width:
    a float bucket ships them as int32 (packing 2 stored bytes would cut
    them). Checked against the oracle."""
    from wvpk.ref import decode_block

    rng = np.random.default_rng(21)
    data = encode_file(rng.integers(-2**22, 2**22, size=(300, 2)),
                       EncodeSpec(block_samples=150, float_data=True,
                                  bytes_stored=2, float_shift=0,
                                  float_max_exp=130, float_norm_exp=127))
    blocks = parse_blocks(data)
    (b,) = group_blocks([x.state for x in blocks])
    assert b.profile.is_float and set(b.bytes_stored) == {1}
    assert pipeline._bucket_bps(b) is None
    got = decode_states([x.state for x in blocks], device="cpu")
    for blk, g in zip(blocks, got):
        want = decode_block(blk.state)
        np.testing.assert_array_equal(g.samples, want.samples)
        assert np.abs(g.samples).max() > 2**15


def test_corrupted_wvx_stream_is_flagged_by_crc_x():
    """A flipped bit in a block's wvx stream leaves the main CRC good; the
    block is flagged through crc_x, as the oracle flags it."""
    from wvpk.ref import decode_block

    data = encode_file(
        np.random.default_rng(22).integers(-2**29, 2**29, size=(300, 2)),
        EncodeSpec(block_samples=150, bytes_stored=4, int32_mode="wvx",
                   int32_sent_bits=7))
    states = [b.state for b in parse_blocks(data)]
    wvx = bytearray(states[1].wvxbits)
    wvx[len(wvx) // 2] ^= 0x10
    states[1].wvxbits = bytes(wvx)
    got = decode_states(states, device="cpu")
    assert [g.crc_error for g in got] == [False, True]
    assert got[1].crc == states[1].header.crc
    assert got[1].crc_x != states[1].crc_mvx
    want = decode_block(states[1])
    assert (want.crc_x, want.crc_error) == (got[1].crc_x, True)
    np.testing.assert_array_equal(want.samples, got[1].samples)


def _open_fds() -> int:
    return len(list(Path("/proc/self/fd").iterdir()))


def test_failed_wvc_pairing_closes_the_correction_file(corpus, tmp_path,
                                                       monkeypatch):
    """When a correction file cannot be paired the open closes it again
    (and decodes lossy, like the plain hybrid file); a paired streaming
    reader is closed by close()."""
    import wvpk.container.stream as stream

    wv, wvc = corpus["hybrid_wvc"]
    (tmp_path / "h.wv").write_bytes(wv)
    (tmp_path / "h.wvc").write_bytes(wvc)

    class Broken:
        def __init__(self, f):
            raise OSError("unreadable correction file")

    lossy = _unpack_all(api, wv, device="cpu")[1]
    for reader, paired in ((Broken, False), (stream.WvcReader, True)):
        monkeypatch.setattr(stream, "WvcReader", reader)
        before = _open_fds()
        for _ in range(2):
            wpc = api.WavpackOpenFileInput(
                str(tmp_path / "h.wv"), flags=consts.OPEN_WVC,
                streaming=True, device="cpu")
            assert wpc.wvc_all_paired is paired
            buf = np.zeros(lossy.size, np.int32)
            api.WavpackUnpackSamples(wpc, buf, lossy.size // 2)
            wpc.close()
            assert np.array_equal(buf, lossy) is not paired
        assert _open_fds() == before


def test_explicit_wvc_with_several_inputs_is_refused(corpus, tmp_path):
    """--wvc PATH names one correction file: with several inputs it is
    refused (exit 2, nothing written), never dropped."""
    wv, wvc = corpus["hybrid_wvc"]
    for name in ("a", "b"):
        (tmp_path / f"{name}.wv").write_bytes(wv)
    (tmp_path / "x.wvc").write_bytes(wvc)
    args = [str(tmp_path / "a.wv"), str(tmp_path / "b.wv"), "--wvc",
            str(tmp_path / "x.wvc"), "-q", "--device", "cpu"]
    assert cli_main(args) == 2
    assert cli_main(args + ["--batch"]) == 2
    assert not list(tmp_path.glob("*.wav"))
    assert cli_main([str(tmp_path / "a.wv"), "--wvc",
                     str(tmp_path / "x.wvc"), "-q", "--device", "cpu"]) == 0
    src = noise(512, 2, 4000, 12).astype("<i2").tobytes()
    assert (tmp_path / "a.wav").read_bytes().endswith(src)


OUT_OF_SLICE = {
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
