"""wvpk_torch vs wvpk through every PCM mode and DSD, on the CPU: the
staged buckets, decode_states, the api unpack and the CLI's output, on a
small mixed corpus (stereo and mono, 8/16/24/32-bit, several term chains,
shift, 5.1 multichannel, one corrupted block, hybrid with and without
bitrate and balance, float, int32+wvx with false stereo, a hybrid file with
its .wvc, DSD modes 0, 1 and 3). Each package parses the same bytes with
its own container. Integer codec: every comparison is exact. The faults of
the reference that the port does not copy are checked against the source
or by what the port does, not against wvpk. Last, the import seam: the
port imports nothing of wvpk or jax, and its copies of wvpk's host layers
(container, testgen) stay in step with the originals."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import wvpk_torch.testgen as port_testgen
from wvpk import api as jax_api
from wvpk.cli import main as jax_cli_main
from wvpk.container import parse_blocks as jax_parse_blocks
from wvpk.container.blocks import pair_wvc as jax_pair_wvc
from wvpk.engine import decode_states as jax_decode_states
from wvpk.engine.staging import group_blocks as jax_group_blocks
from wvpk.ref import decode_block as jax_decode_block
from wvpk.testgen import EncodeSpec, encode_dsd_file, encode_file, \
    encode_multichannel
from wvpk.testgen.encoder import encode_blocks
from wvpk_torch import api, consts
from wvpk_torch.cli import main as cli_main
from wvpk_torch.container import parse_blocks
from wvpk_torch.container.blocks import pair_wvc
from wvpk_torch.engine import decode_states, pipeline
from wvpk_torch.engine.staging import group_blocks
from wvpk_torch.ref import decode_block

from test_torch_cuda import dsd_case, hybrid_float_wvc, lossless_case, \
    parse_case, pcm_case

REPO = Path(__file__).resolve().parents[1]


def noise(n, ch, scale, seed):
    return np.round(np.random.default_rng(seed).normal(0, scale, (n, ch))
                    ).astype(np.int64)


def dsd_bytes(n, ch, seed):
    """DSD byte-samples: 70% runs of a few patterns (large probability
    skew), the rest random."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 256, size=(n, ch))
    runs = r.choice([0x55, 0xAA, 0x33, 0x0F], size=(n, ch))
    return np.where(r.random((n, ch)) < 0.7, runs, base).astype(np.int64)


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
    "dsd_raw": lambda: encode_dsd_file(dsd_bytes(400, 2, 14), 0,
                                       block_samples=200),
    "dsd_fast_mono": lambda: encode_dsd_file(
        dsd_bytes(500, 1, 15), 1, mono=True, history_bits=2,
        block_samples=250),
    "dsd_fast_bins32": lambda: encode_dsd_file(
        dsd_bytes(300, 2, 16), 1, history_bits=5),
    "dsd_high": lambda: encode_dsd_file(dsd_bytes(400, 2, 17), 3,
                                        block_samples=200),
}
DSD = sorted(n for n in CORPUS if n.startswith("dsd"))


def _wvc_pair(pcm, spec):
    """(.wv bytes, .wvc bytes) of a hybrid-lossless encode."""
    sink = []
    wv = b"".join(encode_blocks(pcm, spec, wvc_sink=sink))
    return wv, b"".join(sink)


def _blocks(entry, parse=parse_blocks, pair=pair_wvc):
    """Parsed blocks of a corpus entry, its .wvc paired where it has one;
    the port's container by default, wvpk's with jax_parse_blocks and
    jax_pair_wvc."""
    if isinstance(entry, tuple):
        blocks = parse(entry[0])
        assert pair(blocks, entry[1]) == len(blocks)
        return blocks
    return parse(entry)


def _jax_blocks(entry):
    return _blocks(entry, jax_parse_blocks, jax_pair_wvc)


@pytest.fixture(scope="module")
def corpus():
    return {name: make() for name, make in CORPUS.items()}


def _all_states(corpus, blocks=_blocks):
    return [b.state for entry in corpus.values() for b in blocks(entry)]


def _pcm_states(corpus, blocks=_blocks):
    return [b.state for name, entry in corpus.items()
            if not name.startswith("dsd") for b in blocks(entry)]


def _same_buckets(mine, theirs):
    """Every Bucket field equal (chain_segments and static_terms as
    tuples), and the lanes in the same order."""
    assert len(mine) == len(theirs)
    fields = [f for f in mine[0].__dataclass_fields__
              if f not in ("profile", "states", "chain_segments")]
    for a, b in zip(mine, theirs):
        assert a.profile.__dict__ == b.profile.__dict__
        assert a.chain_segments == b.chain_segments
        assert a.static_terms == b.static_terms
        assert [st.header.crc for st in a.states] == \
            [st.header.crc for st in b.states]
        for f in fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f)


def test_staging_matches_wvpk(corpus):
    mine = group_blocks(_pcm_states(corpus))
    theirs = jax_group_blocks(_pcm_states(corpus, _jax_blocks))
    assert len(mine) > 1
    _same_buckets(mine, theirs)


# A mixed-chain corpus: 64 blocks of 256 samples for each chain of the
# decorrelation kernels' table (the bench chain and the three encoder
# presets), 64 of a chain outside it and 20 of a rarer one, which falls
# into the generic tail segment.
MIXED_CHAINS = {
    "bench": ((18, 17, 2), 64),
    "fast": ((17, 17), 64),
    "default": ((18, 18, 2, 17, 3), 64),
    "high": ((18, 18, 18, -2, 2, 3, 5, -1, 17, 4), 64),
    "outside": ((3, 17, -3), 64),
    "rare": ((18, 2), 20),
}


@pytest.fixture(scope="module")
def mixed_chains():
    """The mixed-chain corpus' .wv files, interleaved block by block."""
    files = []
    for k, (terms, nblocks) in enumerate(MIXED_CHAINS.values()):
        files.append(encode_file(noise(256 * nblocks, 2, 1500 + 400 * k,
                                       40 + k),
                                 EncodeSpec(block_samples=256, joint=True,
                                            terms=terms,
                                            deltas=(2,) * len(terms))))
    return files


def _mixed_states(files, parse):
    per_file = [[b.state for b in parse(f)] for f in files]
    most = max(len(p) for p in per_file)
    return [p[i] for i in range(most) for p in per_file if i < len(p)]


def test_mixed_chain_staging_matches_wvpk(mixed_chains):
    """Lanes sorted by chain as wvpk sorts them: the same lane order,
    indices and chain_segments, every other field equal."""
    mine = group_blocks(_mixed_states(mixed_chains, parse_blocks))
    theirs = jax_group_blocks(_mixed_states(mixed_chains, jax_parse_blocks))
    _same_buckets(mine, theirs)
    (b,) = mine
    assert b.static_terms is None
    chains = [c for c, *_ in b.chain_segments]
    assert chains[-1] is None and len(chains) == len(MIXED_CHAINS)
    assert set(chains[:-1]) == {t for t, n in MIXED_CHAINS.values()
                                if n >= 64}
    for chain, start, stop, ntm in b.chain_segments:
        for st in b.states[start:stop]:
            got = tuple(int(t) for t in st.terms[:st.num_terms])
            assert got == chain or (chain is None and len(got) <= ntm)


def test_mixed_chain_decode_states_matches_wvpk(mixed_chains):
    """The mixed-chain corpus through decode_states on the CPU: equal to
    wvpk's engine block for block, and lossless."""
    want = jax_decode_states(_mixed_states(mixed_chains, jax_parse_blocks))
    got = decode_states(_mixed_states(mixed_chains, parse_blocks),
                        device="cpu")
    assert len(got) == len(want)
    for w, g in zip(want, got):
        _same(w, g)
    assert not any(g.crc_error or g.mute_error for g in got)


def _same(w, g, msg=""):
    np.testing.assert_array_equal(w.samples, g.samples, err_msg=msg)
    assert (w.crc, w.crc_x, w.crc_wvc, w.mute_error, w.crc_error,
            w.wvc_applied) == (g.crc, g.crc_x, g.crc_wvc, g.mute_error,
                               g.crc_error, g.wvc_applied), msg


def test_decode_states_matches_wvpk(corpus):
    """The whole corpus, PCM and DSD mixed, in one call: equal to wvpk's
    engine block for block; the DSD blocks also equal wvpk's oracle."""
    jax_states = _all_states(corpus, _jax_blocks)
    want = jax_decode_states(jax_states)
    got = decode_states(_all_states(corpus), device="cpu")
    assert len(got) == len(want)
    for st, w, g in zip(jax_states, want, got):
        _same(w, g)
        if st.flags & consts.DSD_FLAG:
            np.testing.assert_array_equal(jax_decode_block(st).samples,
                                          g.samples)
    assert sum(g.crc_error for g in got) == 1
    assert any(g.wvc_applied for g in got)
    assert any(g.crc_x != -1 for g in got)


@pytest.mark.parametrize("name", DSD)
def test_dsd_decode_states_matches_wvpk_and_oracle(corpus, name):
    """DSD alone: equal to wvpk's engine and to wvpk's oracle block for
    block; dsd_pipeline.decode_dsd_states gives the same blocks."""
    from wvpk_torch.engine.dsd_pipeline import decode_dsd_states

    jax_states = [b.state for b in _jax_blocks(corpus[name])]
    states = [b.state for b in _blocks(corpus[name])]
    got = decode_states(states, device="cpu")
    want = jax_decode_states(jax_states)
    for st, w, g, a in zip(jax_states, want, got,
                           decode_dsd_states(states, "cpu")):
        _same(w, g, name)
        _same(a, g, name)
        oracle = jax_decode_block(st)
        np.testing.assert_array_equal(oracle.samples, g.samples)
        assert oracle.mute_error == g.mute_error is False


@pytest.mark.parametrize("mode", [0, 1, 3])
def test_corrupted_dsd_block_mutes_as_wvpk(mode):
    """A flipped payload byte: the block's CRC fails, it is muted with
    0x55 fill, and the other blocks decode, as in wvpk."""
    kw = {"history_bits": 2} if mode == 1 else {}
    data = bytearray(encode_dsd_file(dsd_bytes(600, 2, 30 + mode), mode,
                                     block_samples=200, **kw))
    data[-60] ^= 0xFF
    data = bytes(data)
    want = jax_decode_states([b.state for b in jax_parse_blocks(data)])
    got = decode_states([b.state for b in parse_blocks(data)],
                        device="cpu")
    for w, g in zip(want, got):
        _same(w, g, f"mode {mode}")
    assert [g.mute_error for g in got] == [False, False, True]
    assert (got[2].samples == 0x55).all()


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_dsd_matches_wvpk(seed):
    """Random DSD files (test_torch_cuda.dsd_case: modes 0/1/3, mono and
    stereo, history bits 0-5, corrupted bytes): the port equals wvpk's
    engine block for block."""
    data, _src, mode = dsd_case(seed)
    want = jax_decode_states([b.state for b in jax_parse_blocks(data)])
    got = decode_states([b.state for b in parse_blocks(data)], device="cpu")
    for w, g in zip(want, got):
        _same(w, g, f"seed {seed} mode {mode}")


@pytest.mark.parametrize("mode,mono", [(1, False), (1, True), (3, False),
                                       (3, True)])
def test_dsd_blocks_of_one_profile_share_one_group(mode, mono):
    """Blocks of one profile but of different lengths and payload sizes
    form one group, padded to its longest lane (rows of whole words; the
    short lane's row ends inside one), and decode equal to wvpk's engine
    and to the source."""
    from wvpk_torch.engine.dsd_pipeline import group_dsd

    src = dsd_bytes(451, 1 if mono else 2, 40 + mode + mono)
    kw = {"history_bits": 3} if mode == 1 else {}
    data = encode_dsd_file(src, mode, mono=mono, block_samples=202, **kw)
    states = [b.state for b in parse_blocks(data)]
    (g,) = group_dsd(states)
    assert [st.header.block_samples for st in g.sts] == [202, 202, 47]
    assert g.nsteps % 4 == 0
    want = jax_decode_states([b.state for b in jax_parse_blocks(data)])
    got = decode_states(states, device="cpu")
    for w, r in zip(want, got):
        _same(w, r, f"mode {mode}")
    np.testing.assert_array_equal(
        np.concatenate([r.samples for r in got]), src)


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
    """Random lossless files: the port's decode equals wvpk's scalar
    oracle, flags included, and the source PCM wherever the block is
    intact."""
    data, pcm, spec = lossless_case(seed)
    blocks = jax_parse_blocks(data)
    got = decode_states([b.state for b in parse_blocks(data)], device="cpu")
    for blk, g in zip(blocks, got):
        want = jax_decode_block(blk.state)
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
    equals wvpk's scalar oracle, flags included, and the source PCM
    wherever the decode is lossless and the block intact."""
    data, wvc, pcm, spec = pcm_case(seed)
    blocks = parse_case(data, wvc, jax_parse_blocks, jax_pair_wvc)
    got = decode_states([b.state for b in parse_case(data, wvc)],
                        device="cpu")
    lossless = (not spec.hybrid or spec.wvc) and not spec.float_data
    for blk, g in zip(blocks, got):
        want = jax_decode_block(blk.state)
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
    them). Checked against wvpk's oracle."""
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
    for blk, g in zip(jax_parse_blocks(data), got):
        want = jax_decode_block(blk.state)
        np.testing.assert_array_equal(g.samples, want.samples)
        assert np.abs(g.samples).max() > 2**15


def test_corrupted_wvx_stream_is_flagged_by_crc_x():
    """A flipped bit in a block's wvx stream leaves the main CRC good; the
    block is flagged through crc_x, as wvpk's oracle flags it."""
    data = encode_file(
        np.random.default_rng(22).integers(-2**29, 2**29, size=(300, 2)),
        EncodeSpec(block_samples=150, bytes_stored=4, int32_mode="wvx",
                   int32_sent_bits=7))
    states = [b.state for b in parse_blocks(data)]
    jax_states = [b.state for b in jax_parse_blocks(data)]
    wvx = bytearray(states[1].wvxbits)
    wvx[len(wvx) // 2] ^= 0x10
    states[1].wvxbits = jax_states[1].wvxbits = bytes(wvx)
    got = decode_states(states, device="cpu")
    assert [g.crc_error for g in got] == [False, True]
    assert got[1].crc == states[1].header.crc
    assert got[1].crc_x != states[1].crc_mvx
    want = jax_decode_block(jax_states[1])
    assert (want.crc_x, want.crc_error) == (got[1].crc_x, True)
    np.testing.assert_array_equal(want.samples, got[1].samples)


def _open_fds() -> int:
    return len(list(Path("/proc/self/fd").iterdir()))


def test_failed_wvc_pairing_closes_the_correction_file(corpus, tmp_path,
                                                       monkeypatch):
    """When a correction file cannot be paired the open closes it again
    (and decodes lossy, like the plain hybrid file); a paired streaming
    reader is closed by close()."""
    import wvpk_torch.container.stream as stream

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


def test_truncated_wvc_streaming_pairs_only_whole_blocks(corpus, tmp_path):
    """A .wvc cut off inside its last block: the streaming open pairs
    only the correction blocks that lie inside the file, as the eager
    pair_wvc does, so neither reports MODE_WVC | MODE_LOSSLESS; the first
    block decodes lossless, the cut-off one lossy. wvpk's streaming reader
    pairs on the header alone and still reports MODE_WVC (a fault the
    port does not copy)."""
    wv, wvc = corpus["hybrid_wvc"]
    (tmp_path / "h.wv").write_bytes(wv)
    (tmp_path / "h.wvc").write_bytes(wvc[:-10])
    src = noise(512, 2, 4000, 12).reshape(-1)
    lossy = _unpack_all(api, wv, device="cpu")[1]
    assert not np.array_equal(lossy[512:], src[512:])
    lossless = consts.MODE_WVC | consts.MODE_LOSSLESS
    for streaming in (False, True):
        wpc = api.WavpackOpenFileInput(
            str(tmp_path / "h.wv"), flags=consts.OPEN_WVC,
            streaming=streaming, device="cpu")
        assert (wpc.wvc_paired, wpc.wvc_all_paired) == (1, False)
        assert api.WavpackGetMode(wpc) & lossless == 0
        buf = np.zeros(1024, np.int32)
        assert api.WavpackUnpackSamples(wpc, buf, 512) == 512
        wpc.close()
        np.testing.assert_array_equal(buf[:512], src[:512])
        np.testing.assert_array_equal(buf[512:], lossy[512:])
    ref = jax_api.WavpackOpenFileInput(str(tmp_path / "h.wv"),
                                       flags=consts.OPEN_WVC, streaming=True)
    assert ref.wvc_all_paired
    assert jax_api.WavpackGetMode(ref) & lossless == lossless
    ref.close()


def test_wvx_values_wider_than_max_width_pin_the_engine_counter():
    """A new-style wvx block (int32_max_width > 0) whose values are wider
    than max_width, so fewer wvx bits are read than sent. The port stages
    the getbits counter after the leading 5-bit field as bc = 3, as wvpk's
    engine does (wvpk/engine/staging.py:249-251), and with it the window's
    lookahead bit; wvpk's scalar oracle starts the counter at 0
    (wvpk/ref/oracle.py:33-37) and decodes these blocks clean, as the
    encoder stamped them. The C# source that would settle which is right
    is not in the repository, so this pins the port's present result: the
    engine's samples and crc_x, a CRC error on both blocks, and the
    oracle's clean decode beside it. A change to either shows here."""
    data = encode_file(
        np.random.default_rng(23).integers(-2**29, 2**29, size=(300, 2)),
        EncodeSpec(block_samples=150, bytes_stored=4, int32_mode="wvx",
                   int32_sent_bits=6, int32_max_width=24))
    states = [b.state for b in parse_blocks(data)]
    assert [(s.int32_max_width, s.wvx_start_bit) for s in states] == \
        [(24, 5), (24, 5)]
    got = decode_states(states, device="cpu")
    want = jax_decode_states([b.state for b in jax_parse_blocks(data)])
    oracle = [jax_decode_block(b.state) for b in jax_parse_blocks(data)]
    assert [g.crc_error for g in got] == [True, True]
    assert [g.mute_error for g in got] == [False, False]
    assert [g.crc_x for g in got] == [-1105006744, -1976700115]
    assert [o.crc_error for o in oracle] == [False, False]
    assert [o.crc_x for o in oracle] == [s.crc_mvx for s in states]
    for g, w, o in zip(got, want, oracle):
        assert (g.crc, g.crc_x, g.crc_error) == (w.crc, w.crc_x, w.crc_error)
        np.testing.assert_array_equal(g.samples, w.samples)
        assert not np.array_equal(g.samples, o.samples)


def test_hybrid_float_wvc_decodes_to_the_oracle():
    """Hybrid float blocks with a correction stream (random .wvc bits, no
    corpus reaches them): the port's wvc program runs the float restore,
    so its samples are both oracles' (wvpk's and the port's copy), the
    corrections applied; wvpk's fused wvc program skips the restore
    (wvpk/engine/fused.py:129-130), and its samples differ."""
    states = hybrid_float_wvc()
    jax_states = hybrid_float_wvc(jax_parse_blocks)
    (b,) = group_blocks(states)
    assert b.profile.has_wvc and b.profile.is_float
    got = decode_states(states, "cpu")
    for st, jst, g in zip(states, jax_states, got, strict=True):
        want, jax_want = decode_block(st), jax_decode_block(jst)
        np.testing.assert_array_equal(g.samples, want.samples)
        np.testing.assert_array_equal(g.samples, jax_want.samples)
        assert g.wvc_applied
        assert (g.crc_wvc, g.crc_error, g.mute_error) == (
            want.crc_wvc, want.crc_error, want.mute_error) == (
            jax_want.crc_wvc, jax_want.crc_error, jax_want.mute_error)
    assert not all(np.array_equal(j.samples, g.samples)
                   for j, g in zip(jax_decode_states(jax_states), got))


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


def test_cuda_without_gpu_raises(corpus):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: 'cuda' is a valid device here")
    states = [b.state for b in parse_blocks(corpus["stereo16_joint"])]
    with pytest.raises(RuntimeError, match="cuda"):
        decode_states(states, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        api.WavpackOpenFileInput(corpus["stereo16_joint"])




GETTERS = ("WavpackGetNumChannels", "WavpackGetBitsPerSample",
           "WavpackGetBytesPerSample", "WavpackGetSampleRate",
           "WavpackGetReducedChannels", "WavpackGetFileFormat",
           "WavpackGetMode", "WavpackGetVersion", "WavpackGetIsFive",
           "WavpackLossy", "WavpackGetNumErrors", "WavpackGetHeader",
           "WavpackGetTrailer", "WavpackGetMD5Sum")


def _dsf_wv(mode, chs, rate, seed):
    """A DSF file and the .wv that wraps it (wvpk.encode.encode_dsd with
    the DSF header and trailer stored), from random bytes."""
    from wvpk.encode import encode_dsd
    from wvpk.io.dsf import make_dsf, read_dsf

    data = np.random.default_rng(seed).integers(
        0, 256, (3000 + 13, chs)).astype(np.uint8)
    dsf = make_dsf(data, rate, trailer=b"tagdata")
    _d, _r, header, trailer = read_dsf(dsf)
    return dsf, data, encode_dsd(
        data, mode, dsd_rate=rate, header=header, trailer=trailer,
        file_format=jax_api.consts.FORMAT_DSF, history_bits=2)


@pytest.mark.parametrize("name", DSD)
def test_dsd_api_getters_match_wvpk(corpus, name):
    """Every getter of an open DSD file, the native sample count (x8)
    included, and a decode after a seek, as wvpk.api gives them."""
    ctx = [mod.WavpackOpenFileInput(corpus[name], **kw) for mod, kw in (
        (jax_api, {}), (api, {"device": "cpu"}))]
    for getter in GETTERS:
        assert getattr(api, getter)(ctx[1]) == \
            getattr(jax_api, getter)(ctx[0]), getter
    assert api.WavpackGetMode(ctx[1]) & consts.MODE_DSD
    assert api.WavpackGetNumSamples(ctx[1], native=True) == \
        jax_api.WavpackGetNumSamples(ctx[0], native=True)
    bufs = []
    for mod, wpc in zip((jax_api, api), ctx):
        assert mod.SetSample(wpc, 123)
        buf = np.zeros(100 * mod.WavpackGetNumChannels(wpc), np.int32)
        assert mod.WavpackUnpackSamples(wpc, buf, 100) == 100
        bufs.append(buf)
    np.testing.assert_array_equal(bufs[0], bufs[1])


@pytest.mark.parametrize("mode,chs", [(0, 2), (1, 2), (3, 1)])
def test_cli_reproduces_a_dsf_byte_for_byte(tmp_path, mode, chs):
    """A .wv wrapping a DSF decodes back to the original .dsf through the
    port's CLI, as through wvpk's."""
    dsf, _data, wv = _dsf_wv(mode, chs, 2822400 * (1 + (chs == 1)),
                             40 + mode)
    (tmp_path / "a.wv").write_bytes(wv)
    for main, out, extra in ((jax_cli_main, "want.dsf", []),
                             (cli_main, "got.dsf", ["--device", "cpu"])):
        assert main([str(tmp_path / "a.wv"), "-o", str(tmp_path / out),
                     "-q", *extra]) == 0
    assert (tmp_path / "got.dsf").read_bytes() == dsf
    assert (tmp_path / "want.dsf").read_bytes() == dsf


def test_cli_raw_dsd_writes_the_source_bytes(tmp_path):
    """--raw writes the native DSD byte-values alone, interleaved."""
    src = dsd_bytes(700, 2, 50)
    (tmp_path / "a.wv").write_bytes(encode_dsd_file(src, 3,
                                                    block_samples=300))
    assert cli_main([str(tmp_path / "a.wv"), "-o", str(tmp_path / "a.raw"),
                     "--raw", "-q", "--device", "cpu"]) == 0
    assert (tmp_path / "a.raw").read_bytes() == \
        src.astype(np.uint8).tobytes()


# -- the import seam --------------------------------------------------------

BANNED = ("jax", "wvpk")


def _banned_imports(path: Path) -> list[str]:
    """Absolute imports of jax, wvpk or their submodules in one file
    (wvpk_torch and relative imports are allowed)."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [f"{path.name}:{node.lineno} {n}" for n in names
                if n.split(".")[0] in BANNED]
    return bad


_GUARDED_RUN = """
import sys


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {banned!r}:
            raise ImportError("the port imported " + name)
        return None


sys.meta_path.insert(0, Refuse())
import wvpk_torch.api, wvpk_torch.cli, wvpk_torch.encode, wvpk_torch.engine
import wvpk_torch.debug, wvpk_torch.parallel
import wvpk_torch.parallel.dryrun, wvpk_torch.report, wvpk_torch.testgen
import wvpk_torch.testgen.faults, wvpk_torch.testgen.fuzzspec
from wvpk_torch.cli import main

for path in sys.argv[1:]:
    encode = ["--encode", "--block-samples", "256"] \
        if path.endswith(".wav") else ["--report"]
    assert main([*encode, path, "-q", "--device", "cpu"]) == 0, path
assert main([sys.argv[1], "--verify-checksums", "-q"]) == 0
wvpk_torch.debug.checkify_smoke("cpu")
assert wvpk_torch.testgen.fuzzspec.run_hw_sweep(
    n_cases=1, n_dsd=1, n_mc=0, n_wvc=0, device="cpu", mesh=["cpu", "cpu"],
    verbose=False)[0] == 0
"""


def _seam_static(tmp_path):
    files = sorted((REPO / "wvpk_torch").rglob("*.py"))
    assert len(files) > 30
    names = {str(f.relative_to(REPO / "wvpk_torch")) for f in files}
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/dryrun.py",
            "debug.py", "report.py", "trace.py",
            "testgen/fuzzspec.py", "testgen/faults.py"} <= names
    bad = [b for f in files + [REPO / "chip_smoke.py"]
           for b in _banned_imports(f)]
    assert not bad, bad


def _seam_runtime(tmp_path):
    """A lossless file, a hybrid file beside its .wvc and a DSD file
    decode through the port's CLI with --report, the lossless one is
    audited with --verify-checksums, a WAV encodes with the device encoder
    and decodes back byte for byte, the debug smoke runs and a small sweep
    runs on a two-entry CPU mesh, in a process that refuses every import
    of jax and wvpk."""
    from wvpk_torch.io.wav import make_wav_header

    wv, wvc = _wvc_pair(noise(512, 2, 4000, 12), EncodeSpec(
        block_samples=256, joint=True, hybrid=True, bitrate=300, wvc=True))
    pcm = noise(600, 2, 3000, 2)
    wav = make_wav_header(600, 2, 44100, 16, 2) + pcm.astype("<i2").tobytes()
    files = {"lossless.wv": encode_file(noise(600, 2, 3000, 1),
                                        EncodeSpec(block_samples=300)),
             "hybrid.wv": wv, "hybrid.wvc": wvc,
             "dsd.wv": encode_dsd_file(dsd_bytes(300, 2, 3), 1),
             "encoded.wav": wav}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    paths = [str(tmp_path / n) for n in files if n.endswith((".wv", ".wav"))]
    proc = subprocess.run(
        [sys.executable, "-c", _GUARDED_RUN.format(banned=BANNED), *paths,
         str(tmp_path / "encoded.wv")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for name in ("lossless", "hybrid", "dsd"):
        assert (tmp_path / f"{name}.wav").stat().st_size > 44
    assert (tmp_path / "encoded.wav").read_bytes() == wav


@pytest.mark.parametrize("check", [_seam_static, _seam_runtime],
                         ids=["ast_scan", "guarded_cli_decode"])
def test_port_imports_neither_wvpk_nor_jax(check, tmp_path):
    check(tmp_path)


def _same_fields(a, b, where):
    """Field-by-field equality of two parsed objects of the two packages
    (dataclasses, numpy arrays, lists, plain values)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same_fields(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            _same_fields(x, y, f"{where}[{k}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_port_container_parses_as_wvpk(corpus, name):
    """The port's copy of the container layer parses every corpus file
    (wvc pairs included) to the same blocks as wvpk's, field by field."""
    for k, (a, b) in enumerate(zip(_blocks(corpus[name]),
                                   _jax_blocks(corpus[name]), strict=True)):
        _same_fields(a.state, b.state, f"{name} block {k}")
        _same_fields(a.updates, b.updates, f"{name} block {k} updates")


def _wvc_bytes(testgen):
    sink = []
    wv = b"".join(testgen.encoder.encode_blocks(
        noise(600, 2, 4000, 60), testgen.EncodeSpec(
            block_samples=256, joint=True, hybrid=True, hybrid_bitrate=True,
            bitrate=320, bitrate_delta=1, wvc=True), wvc_sink=sink))
    return wv + b"".join(sink)


ENCODES = {
    "pcm": lambda tg: tg.encode_file(
        noise(700, 2, 3000, 61), tg.EncodeSpec(
            block_samples=300, joint=True, terms=(17, -1, 5),
            deltas=(2, 3, 1))),
    "multichannel": lambda tg: tg.encode_multichannel(
        noise(400, 6, 3000, 62), tg.EncodeSpec(block_samples=200)),
    "hybrid_wvc": _wvc_bytes,
    "dsd0": lambda tg: tg.encode_dsd_file(dsd_bytes(300, 2, 63), 0),
    "dsd1": lambda tg: tg.encode_dsd_file(dsd_bytes(300, 1, 64), 1,
                                          mono=True, history_bits=3),
    "dsd3": lambda tg: tg.encode_dsd_file(dsd_bytes(300, 2, 65), 3),
}


@pytest.mark.parametrize("name", sorted(ENCODES))
def test_port_testgen_encodes_as_wvpk(name):
    """The port's copy of testgen makes byte-identical files for the same
    specs (PCM, multichannel, hybrid + .wvc, DSD modes 0, 1 and 3)."""
    import wvpk.testgen as jax_testgen

    assert ENCODES[name](port_testgen) == ENCODES[name](jax_testgen)
