"""wvpk_torch's plain entropy decoder, hybrid profile and wvc outputs, and
its correction-stream scan, vs wvpk's: the XLA scan and the Pallas kernel
in interpret mode, on the same staged buckets. Integer codec: every
comparison is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

from wvpk.container import parse_blocks
from wvpk.container.blocks import pair_wvc
from wvpk.engine.staging import group_blocks
from wvpk.ops.entropy import entropy_decode as jax_entropy_decode
from wvpk.ops.entropy import wvc_corrections as jax_wvc_corrections
from wvpk.ops.entropy_pallas import entropy_decode_pallas
from wvpk.testgen import EncodeSpec, encode_file
from wvpk.testgen.encoder import encode_blocks
from wvpk_torch.engine.staging import bucket_tensors
from wvpk_torch.ops.entropy import entropy_decode, wvc_corrections
from wvpk_torch.ops.entropy_cuda import entropy_decode_wvc_cuda
from wvpk_torch.ops.entropy_select import entropy_decode_any, \
    entropy_decode_wvc_any, wvc_corrections_any
from wvpk_torch.ops.wvc_cuda import wvc_corrections_cuda
from wvpk_torch.testgen.edge import wvc_edge_lanes

CPU = torch.device("cpu")


def noise(n, ch, scale, seed):
    return np.round(np.random.default_rng(seed).normal(0, scale, (n, ch))
                    ).astype(np.int64)


def _zero_runs():
    pcm = np.zeros((512, 2), np.int64)
    pcm[100:140] = noise(40, 2, 80, 3)
    return encode_file(pcm, EncodeSpec(
        block_samples=256, joint=True, initial_medians=((0, 0, 0),
                                                        (0, 0, 0)),
        hybrid=True, hybrid_bitrate=True, bitrate=300, bitrate_delta=1))


def _truncated():
    # a run of 0xff bytes inside the first block's payload reads as more
    # than LIMIT_ONES ones: the lane breaks as at the end of its stream
    data = bytearray(encode_file(noise(512, 2, 2000, 5), EncodeSpec(
        block_samples=256, joint=True, hybrid=True, bitrate=500)))
    data[120:160] = b"\xff" * 40
    return bytes(data)


def _balance_clamped():
    # one silent channel drives the balance past +/- bitrate (the clamp
    # arms of update_error_limit)
    rng = np.random.default_rng(8)
    pcm = np.stack([np.round(rng.normal(0, 25000, 256)), np.zeros(256)],
                   axis=1).astype(np.int64)
    return encode_file(pcm, EncodeSpec(
        block_samples=256, joint=True, hybrid=True, hybrid_bitrate=True,
        hybrid_balance=True, bitrate=70, bitrate_delta=2))


CASES = {
    "stereo_bitrate_balance": lambda: encode_file(
        noise(600, 2, 3000, 1),
        EncodeSpec(block_samples=300, joint=True, hybrid=True,
                   hybrid_bitrate=True, hybrid_balance=True, bitrate=400,
                   bitrate_delta=2)),
    "stereo_balance_clamped": _balance_clamped,
    "stereo_bitrate": lambda: encode_file(
        noise(512, 2, 6000, 2),
        EncodeSpec(block_samples=256, hybrid=True, hybrid_bitrate=True,
                   bitrate=900, bitrate_delta=1, terms=(17, -1, 2),
                   deltas=(2, 2, 2))),
    "stereo_plain": lambda: encode_file(
        noise(512, 2, 7000, 4),
        EncodeSpec(block_samples=256, joint=True, hybrid=True, bitrate=600)),
    "mono_bitrate": lambda: encode_file(
        noise(400, 1, 3000, 6),
        EncodeSpec(block_samples=256, mono=True, hybrid=True,
                   hybrid_bitrate=True, bitrate=300, bitrate_delta=2,
                   terms=(18, 2), deltas=(2, 1))),
    "mono_plain": lambda: encode_file(
        noise(512, 1, 3000, 7),
        EncodeSpec(block_samples=256, mono=True, hybrid=True, bitrate=350)),
    "zero_runs": _zero_runs,
    "truncated": _truncated,
}


def _bucket(name):
    return group_blocks([b.state for b in parse_blocks(CASES[name]())])[0]


def _kw(prof):
    return dict(mono=prof.mono, hybrid=True,
                hybrid_bitrate=prof.hybrid_bitrate,
                hybrid_balance=prof.hybrid_balance, nsteps=prof.nsteps)


def _port(b, wvc=False):
    t = bucket_tensors(b, CPU)
    out = entropy_decode(t["words"], t["nwords_lane"], t["med"], t["slow"],
                         t["acc"], t["delta"], wvc=wvc, **_kw(b.profile))
    return [o.numpy() for o in out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_hybrid_entropy_matches_xla(name):
    b = _bucket(name)
    assert b.profile.hybrid
    want = jax_entropy_decode(b.words, b.nwords_lane, b.med, b.slow, b.acc,
                              b.delta, **_kw(b.profile))
    got = _port(b)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g)
    if name == "truncated":
        assert got[1].tolist() == [True, False] and got[2][0] < 512
    if name == "zero_runs":
        assert (got[0] == 0).mean() > 0.5


# the Pallas interpreter takes ~10 s a lane here: one stereo and one mono
# bucket (the XLA comparisons above cover every case)
@pytest.mark.parametrize("name", ["stereo_balance_clamped", "mono_bitrate"])
def test_hybrid_entropy_matches_pallas_interpret(name):
    b = _bucket(name)
    want = entropy_decode_pallas(
        b.words.astype(np.uint32), b.nwords_lane, b.med, b.slow, b.acc,
        b.delta, interpret=True, **_kw(b.profile))
    for w, g in zip(want, _port(b)):
        np.testing.assert_array_equal(np.asarray(w), g)


def wvc_pair(pcm, spec):
    """Parsed blocks of a hybrid file with its correction file paired."""
    sink = []
    blocks = parse_blocks(b"".join(encode_blocks(pcm, spec, wvc_sink=sink)))
    assert pair_wvc(blocks, b"".join(sink)) == len(blocks)
    return blocks


WVC_CASES = {
    "stereo_bitrate_balance": lambda: wvc_pair(
        noise(600, 2, 3000, 11),
        EncodeSpec(block_samples=300, joint=True, hybrid=True,
                   hybrid_bitrate=True, hybrid_balance=True, bitrate=300,
                   bitrate_delta=2, wvc=True)),
    "stereo_plain_cross_terms": lambda: wvc_pair(
        noise(512, 2, 5000, 12),
        EncodeSpec(block_samples=256, hybrid=True, bitrate=500, wvc=True,
                   terms=(17, -3, 2), deltas=(2, 2, 2))),
    "mono_bitrate": lambda: wvc_pair(
        noise(512, 1, 2000, 13),
        EncodeSpec(block_samples=256, mono=True, hybrid=True,
                   hybrid_bitrate=True, bitrate=250, bitrate_delta=1,
                   wvc=True)),
}


@pytest.mark.parametrize("name", sorted(WVC_CASES))
def test_wvc_outputs_and_corrections_match_xla(name):
    b = group_blocks([x.state for x in WVC_CASES[name]()])[0]
    assert b.profile.has_wvc
    res, mc, base, broke, ndec = jax_entropy_decode(
        b.words, b.nwords_lane, b.med, b.slow, b.acc, b.delta, wvc=True,
        **_kw(b.profile))
    got = _port(b, wvc=True)
    for w, g in zip((res, mc, base, broke, ndec), got):
        np.testing.assert_array_equal(np.asarray(w), g)
    assert (got[1] > 0).any()
    want_corr = np.asarray(jax_wvc_corrections(b.wvc_words, mc, base, res))
    corr = wvc_corrections(*(torch.from_numpy(np.array(a)) for a in (
        b.wvc_words.view(np.int32), mc, base, res)))
    np.testing.assert_array_equal(want_corr, corr.numpy())
    assert (want_corr != 0).any()


def _wvc_walk(words, maxcode, base, residuals):
    """A scalar walk of the correction scan over numpy inputs, Stream::peek
    semantics written out (a position past the start of the row's last
    word reads from that start, then the 0xFFFFFFFF fill): its corrections
    (T, L, C) int32, the count of each branch taken and each lane's final
    cursor (bits)."""
    T, L, C = maxcode.shape
    W = words.shape[1]
    rows = words.view(np.uint32).tolist()
    max_bit = (W - 1) * 32
    corr = np.zeros((T, L, C), np.int64)
    n = {f"bits_{b}": 0 for b in range(32)}
    n.update(extra=0, no_extra=0, negative=0, wrap=0, in_row=0,
             crosses_last_word_start=0, past_last_word_start=0,
             lanes_in_row=0, lanes_past=0)
    ends = np.zeros(L, np.int64)
    for i in range(L):
        pos = 0
        for t in range(T):
            for c in range(C):
                mc = int(maxcode[t, i, c])
                b = mc.bit_length() if mc > 0 else 0
                n[f"bits_{b}"] += 1
                if b == 0:
                    continue
                bp = min(pos, max_bit)
                hi = rows[i][(bp >> 5) + 1] if (bp >> 5) + 1 < W \
                    else 0xFFFFFFFF
                win = (rows[i][bp >> 5] | hi << 32) >> (bp & 31)
                extras = ((1 << (b & 31)) - mc - 1) if b < 31 \
                    else -(1 << 31) - mc - 1
                code = win & ((1 << (b - 1)) - 1)
                take = b - 1
                if code >= extras:
                    code = (code << 1) - extras + (win >> take & 1)
                    take += 1
                    n["extra"] += 1
                else:
                    n["no_extra"] += 1
                where = ("past_last_word_start" if pos > max_bit else
                         "crosses_last_word_start" if pos + take > max_bit
                         else "in_row")
                n[where] += 1
                pos += take
                mag = int(base[t, i, c]) + code
                n["wrap"] += not -(1 << 31) <= mag < 1 << 31
                neg = residuals[t, i, c] < 0
                n["negative"] += bool(neg)
                corr[t, i, c] = -mag if neg else mag
        n["lanes_past" if pos > max_bit else "lanes_in_row"] += 1
        ends[i] = pos
    return (corr & 0xFFFFFFFF).astype(np.uint32).view(np.int32), n, ends


@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
def test_wvc_edge_lanes_plain_matches_xla(mono):
    """The correction scan's edge lanes (testgen/edge.py::wvc_edge_lanes:
    maxcodes of every bit length 0-31 and negative, codes on both sides of
    extras, negative residuals, base + code past int32, rows read past
    their last word's start): the port's plain wvc_corrections equals
    wvpk's XLA scan and a scalar walk, which counts that each branch was
    taken."""
    words, mc, base, res = wvc_edge_lanes(64, seed=21, mono=mono)
    want = np.asarray(jax_wvc_corrections(words.view(np.uint32), mc, base,
                                          res))
    got = wvc_corrections(*(torch.from_numpy(a)
                            for a in (words, mc, base, res)))
    np.testing.assert_array_equal(want, got.numpy())
    walk, n, _ends = _wvc_walk(words, mc, base, res)
    np.testing.assert_array_equal(want, walk)
    missing = [k for k, v in n.items() if v == 0]
    assert not missing, f"branches not reached: {missing} ({n})"


@pytest.mark.parametrize("profile", ["wvc", "wvc_mono"])
def test_wvc_edge_streams_plain_matches_xla(profile):
    """The wvc profiles' edge streams (testgen/edge.py::edge_states: noise,
    zero runs, escapes, truncated, corrupted and zero-filled payloads, and
    lanes whose .wvc is cut to a third): the port's plain entropy decode
    gives the scan its inputs, and the port's plain wvc_corrections equals
    wvpk's XLA scan and the scalar walk on them. On each cut lane the
    cursor runs past the lane's correction stream into the row's fill."""
    from wvpk_torch.engine.staging import group_blocks as port_group_blocks
    from wvpk_torch.testgen.edge import WVC_CUT_EVERY, edge_states, \
        wvc_min_bits

    (b,) = port_group_blocks(edge_states(profile, 2 * WVC_CUT_EVERY, seed=3))
    assert b.profile.has_wvc
    res, mc, base, _broke, _ndec = _port(b, wvc=True)
    words = np.ascontiguousarray(b.wvc_words).view(np.int32)
    want = np.asarray(jax_wvc_corrections(words.view(np.uint32), mc, base,
                                          res))
    got = wvc_corrections(*(torch.from_numpy(np.array(a))
                            for a in (words, mc, base, res)))
    np.testing.assert_array_equal(want, got.numpy())
    walk, _n, ends = _wvc_walk(words, mc, base, res)
    np.testing.assert_array_equal(want, walk)
    stream_bits = np.asarray([8 * len(st.wvcbits) for st in b.states])
    cut = np.arange(len(b.states)) % WVC_CUT_EVERY == 0
    assert (ends[cut] > stream_bits[cut]).all(), (ends, stream_bits)
    # the card tests' bound on the cursor (no walk there)
    least = wvc_min_bits(mc)
    assert (least <= ends).all() and (least[cut] > stream_bits[cut]).all()
    assert (want != 0).any()


def test_wvc_outputs_match_pallas_interpret():
    b = group_blocks([x.state for x in WVC_CASES["mono_bitrate"]()])[0]
    want = entropy_decode_pallas(
        b.words.astype(np.uint32), b.nwords_lane, b.med, b.slow, b.acc,
        b.delta, interpret=True, wvc=True, **_kw(b.profile))
    for w, g in zip(want, _port(b, wvc=True)):
        np.testing.assert_array_equal(np.asarray(w), g)


def test_dispatch_takes_plain_on_cpu():
    b = group_blocks([x.state for x in WVC_CASES["mono_bitrate"]()])[0]
    t = bucket_tensors(b, CPU)
    kw = _kw(b.profile)
    args = (t["words"], t["nwords_lane"], t["med"], t["slow"], t["acc"],
            t["delta"])
    want = _port(b, wvc=True)
    plain = entropy_decode_any(*args, **kw)
    for w, g in zip([want[0]] + want[3:], plain):
        np.testing.assert_array_equal(w, g.numpy())
    del kw["hybrid"]
    got = entropy_decode_wvc_any(*args, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g.numpy())
    corr = wvc_corrections_any(t["wvc_words"], *got[1:3], got[0])
    np.testing.assert_array_equal(
        corr.numpy(), wvc_corrections(t["wvc_words"], *got[1:3],
                                      got[0]).numpy())


def test_kernel_wrappers_refuse_cpu_tensors():
    b = group_blocks([x.state for x in WVC_CASES["mono_bitrate"]()])[0]
    t = bucket_tensors(b, CPU)
    with pytest.raises(ValueError, match="CUDA"):
        entropy_decode_wvc_cuda(
            t["words"], t["nwords_lane"], t["med"], t["slow"], t["acc"],
            t["delta"], mono=True, nsteps=b.profile.nsteps,
            hybrid_bitrate=True, hybrid_balance=False)
    z = torch.zeros((4, b.words.shape[0], 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        wvc_corrections_cuda(t["wvc_words"], z, z, z)
