"""wvpk_torch's plain DSD decoders vs wvpk/ops/dsd.py (XLA on the CPU).

Each case encodes a few DSD blocks with wvpk.testgen.encode_dsd_file,
parses them with wvpk's container, stages them once as numpy arrays and
hands the same arrays to both packages; the edge-lane cases take the
port's testgen/edge.py lanes, which reach every branch of the coders.
Integer codec: every output is compared exactly (codes, err, CRCs), and
on a clean stream the CRC must also equal the block header's.
"""

import numpy as np
import pytest
import torch

from wvpk.container import parse_blocks
from wvpk.ops.dsd import dsd_fast_decode as jax_fast
from wvpk.ops.dsd import dsd_high_decode as jax_high
from wvpk.ops.dsd import dsd_raw_crc as jax_raw_crc
from wvpk.testgen import encode_dsd_file
from wvpk_torch.engine.dsd_pipeline import group_dsd, group_tensors
from wvpk_torch.ops.dsd import dsd_fast_decode, dsd_fast_decode_bytes, \
    dsd_high_decode, dsd_high_decode_bytes, dsd_raw_crc
from wvpk_torch.ops.dsd_cuda import dsd_fast_decode_cuda, \
    dsd_high_decode_cuda, int64_lanes
from wvpk_torch.ops.dsd_select import dsd_fast_decode_any, \
    dsd_high_decode_any
from wvpk_torch.testgen.edge import DSD_EDGE_PROFILES, dsd_edge_states


def _pow2(n, lo=64):
    v = lo
    while v < n:
        v *= 2
    return v


def dsd_states(mode, nsamp, mono, seed, lanes=3, smooth=False, corrupt=None,
               **kw):
    """Block states of `lanes` encoded files (one block each). `smooth`
    takes low-entropy bytes (large probability skew: the mode-1 interval
    reset runs often); `corrupt` flips a byte at that offset from the
    end of the first file."""
    rng = np.random.default_rng(seed)
    ch = 1 if mono else 2
    states = []
    for k in range(lanes):
        if smooth:
            d = (rng.integers(0, 4, (nsamp, ch)) * 0x55) & 0xFF
        else:
            d = rng.integers(0, 256, (nsamp, ch))
        data = bytearray(encode_dsd_file(d.astype(np.int64), mode,
                                         mono=mono, **kw))
        if corrupt is not None and k == 0:
            data[-corrupt] ^= 0xFF
        states += [b.state for b in parse_blocks(bytes(data))
                   if b.state.header.block_samples]
    return states


def stage(states):
    """The common arrays of a group of same-profile states."""
    cap = _pow2(max(len(st.dsd.data) for st in states), 16)
    data = np.zeros((len(states), cap), np.uint8)
    for k, st in enumerate(states):
        data[k, :len(st.dsd.data)] = np.frombuffer(st.dsd.data, np.uint8)
    nbytes = np.asarray([len(st.dsd.data) for st in states], np.int64)
    value0 = np.asarray([st.dsd.value for st in states], np.int64)
    nsamples = np.asarray([st.header.block_samples for st in states],
                          np.int32)
    return data, nbytes, value0, nsamples


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def run_fast(states, mono):
    data, nbytes, value0, nsamples = stage(states)
    bins = states[0].dsd.history_bins
    nvals = nsamples * (1 if mono else 2)
    nsteps = _pow2(int(nvals.max()))
    summed = np.stack([st.dsd.summed_probabilities.astype(np.int32)
                       .reshape(-1) for st in states])
    probs = np.stack([st.dsd.probabilities.astype(np.int32).reshape(-1)
                      for st in states])
    vlook = np.stack([st.dsd.value_lookup.astype(np.int32)
                      for st in states])
    lk = max(max(st.dsd.lookup_buffer.size for st in states), 1)
    lookup = np.zeros((len(states), lk), np.int32)
    for k, st in enumerate(states):
        lookup[k, :st.dsd.lookup_buffer.size] = st.dsd.lookup_buffer
    want = jax_fast(data.astype(np.int32), nbytes, summed, probs, vlook,
                    lookup, value0, np.full(len(states), bins, np.int64),
                    nvals, mono=mono, nsteps=nsteps)
    args = _t(data, nbytes, summed, value0, nvals)
    got = dsd_fast_decode(*args, bins=bins, mono=mono, nsteps=nsteps)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    check_rows(dsd_fast_decode_bytes(*args, bins=bins, mono=mono,
                                     nsteps=nsteps), got)
    return got


def check_rows(rows, got):
    """The `*_bytes` version (the kernels' contract) gives each lane's
    codes as one uint8 row in its memory order, the rest unchanged."""
    out = got[0].numpy()
    want = out.reshape(out.shape[0], out.shape[1], -1).transpose(1, 0, 2)
    assert rows[0].dtype == torch.uint8
    np.testing.assert_array_equal(rows[0].numpy(),
                                  want.reshape(out.shape[1], -1))
    for w, g in zip(got[1:], rows[1:]):
        assert torch.equal(w, g)


def run_high(states, mono):
    data, nbytes, value0, nsamples = stage(states)
    nsteps = _pow2(int(nsamples.max()))
    ptable = np.stack([st.dsd.ptable for st in states]).astype(np.int32)
    filters = np.stack([st.dsd.filters for st in states]).astype(np.int32)
    want = jax_high(data.astype(np.int32), nbytes, ptable, filters, value0,
                    nsamples, mono=mono, nsteps=nsteps)
    args = _t(data, nbytes, ptable, filters, value0, nsamples)
    got = dsd_high_decode(*args, mono=mono, nsteps=nsteps)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    check_rows(dsd_high_decode_bytes(*args, mono=mono, nsteps=nsteps), got)
    return got


def _header_crcs(states):
    return np.asarray([st.header.crc for st in states], np.int32)


@pytest.mark.parametrize("mono", [False, True])
@pytest.mark.parametrize("history_bits", [0, 1, 2, 3, 5])
def test_fast_matches_xla(history_bits, mono):
    n = 300 if history_bits == 5 else 500
    states = dsd_states(1, n, mono, 40 + 2 * history_bits + mono,
                        smooth=history_bits == 3,
                        history_bits=history_bits)
    assert states[0].dsd.history_bins == 1 << history_bits
    _out, err, crc = run_fast(states, mono)
    assert not err.any()
    np.testing.assert_array_equal(crc.numpy(), _header_crcs(states))


@pytest.mark.parametrize("mono,nsamp", [(False, 500), (True, 600),
                                        (False, 300)])
def test_high_matches_xla(mono, nsamp):
    """Mono and stereo; 300 steps cross the Pallas kernel's 256-step
    chunk boundary."""
    states = dsd_states(3, nsamp, mono, 60 + nsamp + mono, lanes=2)
    _out, crc = run_high(states, mono)
    np.testing.assert_array_equal(crc.numpy(), _header_crcs(states))


def test_fast_corrupted_payload_sets_err():
    """A flipped payload byte sends mode 1 down its error path (err set,
    later outputs 0) or to a CRC mismatch, as in XLA."""
    states = dsd_states(1, 400, False, 70, lanes=2, corrupt=30,
                        history_bits=2)
    _out, err, crc = run_fast(states, False)
    bad = err.numpy() | (crc.numpy() != _header_crcs(states))
    assert bad.tolist() == [True, False]


def test_fast_error_path_freezes_lane():
    """A zeroed cumulative table (sp255 == 0) stops the lane at its first
    step with err set and every output 0, in both versions."""
    states = dsd_states(1, 200, True, 71, lanes=2, history_bits=0)
    states[0].dsd.summed_probabilities = np.zeros_like(
        states[0].dsd.summed_probabilities)
    out, err, _crc = run_fast(states, True)
    assert err.tolist() == [True, False]
    assert not out[:, 0].any()


def test_high_corrupted_payload_crc_mismatch():
    states = dsd_states(3, 400, False, 72, lanes=2, corrupt=40)
    _out, crc = run_high(states, False)
    assert (crc.numpy() != _header_crcs(states)).tolist() == [True, False]


@pytest.mark.parametrize("n", [1, 37, 1000])
def test_raw_crc_matches_xla(n):
    rng = np.random.default_rng(80 + n)
    data = rng.integers(0, 256, (4, n)).astype(np.uint8)
    nvalid = np.asarray([n, 0, n // 2, max(n - 3, 0)], np.int32)
    want = jax_raw_crc(data.astype(np.int32), nvalid)
    got = dsd_raw_crc(*_t(data, nvalid))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_raw_crc_matches_header():
    """Mode 0 blocks: the CRC over the raw bytes equals the header's."""
    states = dsd_states(0, 500, False, 81, lanes=3)
    data, _nbytes, _v, nsamples = stage(states)
    got = dsd_raw_crc(*_t(data, nsamples * 2))
    np.testing.assert_array_equal(got.numpy(), _header_crcs(states))


def test_dispatch_takes_plain_version_on_cpu():
    """The select layer runs the plain versions (the `*_bytes` rows) for
    CPU tensors; the kernel wrappers refuse them."""
    states = dsd_states(1, 100, True, 90, lanes=1, history_bits=1)
    data, nbytes, value0, nsamples = stage(states)
    summed = states[0].dsd.summed_probabilities.astype(np.int32)
    args = _t(data, nbytes, summed.reshape(1, -1), value0, nsamples)
    kw = dict(bins=2, mono=True, nsteps=128)
    for w, g in zip(dsd_fast_decode_bytes(*args, **kw),
                    dsd_fast_decode_any(*args, **kw)):
        assert torch.equal(w, g)
    with pytest.raises(ValueError, match="CUDA"):
        dsd_fast_decode_cuda(*args, **kw)
    states = dsd_states(3, 100, True, 91, lanes=1)
    data, nbytes, value0, nsamples = stage(states)
    args = _t(data, nbytes, states[0].dsd.ptable[None].astype(np.int32),
              states[0].dsd.filters[None].astype(np.int32), value0,
              nsamples)
    for w, g in zip(dsd_high_decode_bytes(*args, mono=True, nsteps=128),
                    dsd_high_decode_any(*args, mono=True, nsteps=128)):
        assert torch.equal(w, g)
    with pytest.raises(ValueError, match="CUDA"):
        dsd_high_decode_cuda(*args, mono=True, nsteps=128)


# -- edge lanes (wvpk_torch/testgen/edge.py): every branch of the coders --

def _fast_branches(st, mono):
    """The branches a scalar mode-1 decode of `st` takes (DsdUtils.cs:
    244-304, the reference's byte loop for the renormalisation)."""
    M = 0xFFFFFFFF
    d = st.dsd
    tab = d.summed_probabilities.astype(np.int64)
    data, nb = d.data, len(d.data)
    value, low, high, p0, p1, bptr = d.value, 0, M, 0, 0, 0
    hit = set()
    for _ in range(st.header.block_samples * (1 if mono else 2)):
        r = tab[p0]
        sp = int(r[255])
        if sp == 0:
            hit.add("empty_row")
            break
        if sp == 255 * 256:
            hit.add("ceiling_row")
        mult = ((high - low) & M) // sp
        if mult == 0:
            if nb - bptr >= 4:
                hit.add("reload4")
                value = int.from_bytes(data[bptr:bptr + 4], "big")
                bptr += 4
            else:
                hit.add("reload_short")
            low, high, mult = 0, M, M // sp
        index = ((value - low) & M) // mult
        if index >= sp:
            hit.add("past_table")
            break
        code = int(np.searchsorted(r, index, side="right"))
        base = int(r[code - 1]) if code else 0
        low = (low + base * mult) & M
        high = (low + (int(r[code]) - base) * mult - 1) & M
        while ((high ^ low) & 0xFF000000) == 0:
            if bptr >= nb:
                hit.add("out_of_bytes")
                break
            value = ((value << 8) | data[bptr]) & M
            bptr += 1
            high, low = ((high << 8) | 0xFF) & M, (low << 8) & M
        h = code & (d.history_bins - 1)
        p0, p1 = (h, p1) if mono else (p1, h)
    return hit


def _edge_rows_end_short(states):
    """Byte counts ending 1, 2 and 3 bytes before the group's row width
    (the longest payload padded to a multiple of 4)."""
    nb = [len(st.dsd.data) for st in states]
    width = -(-max(nb) // 4) * 4
    return {width - n for n in nb} >= {1, 2, 3}


@pytest.mark.parametrize("profile", sorted(DSD_EDGE_PROFILES))
def test_edge_lanes_plain_matches_xla(profile):
    """64 edge lanes per DSD profile: the plain decoders equal wvpk's XLA
    ones on every output (codes, err, CRCs); the lanes reach every branch
    the kernels take (mode 1: an empty row, the mult == 0 reset with 4 and
    with fewer bytes left, an index past the table, a payload running out
    mid-step, a row at the 65,280 ceiling; mode 3: filters outside the
    32-bit body's range, all-0x00 and all-0xff payloads, truncation), and
    byte counts end 1 to 3 bytes before the row width."""
    mode, mono, _hb = DSD_EDGE_PROFILES[profile]
    states = dsd_edge_states(profile, 64, seed=7)
    assert _edge_rows_end_short(states)
    hdr = _header_crcs(states)
    if mode == 1:
        _out, err, crc = run_fast(states, mono)
        assert set.union(*(_fast_branches(st, mono) for st in states)) == {
            "empty_row", "reload4", "reload_short", "past_table",
            "out_of_bytes", "ceiling_row"}
        assert err.any() and not err.all()
    else:
        _out, crc = run_high(states, mono)
        wide = int64_lanes(*_t(np.stack([st.dsd.ptable for st in states]),
                               np.stack([st.dsd.filters for st in states])),
                           mono)
        assert 0 < int(wide.sum()) < len(states)
        assert {bytes(set(st.dsd.data)) for st in states} >= {b"\x00",
                                                              b"\xff"}
    clean = crc.numpy() == hdr
    assert clean.any() and not clean.all()


def test_payload_padding_leaves_plain_decode_unchanged():
    """group_dsd pads each group's payload rows to a multiple of 4 bytes
    (the kernels read whole words); the plain decoders read only each
    lane's `nbytes`, so the padding and what it holds change nothing."""
    states = {p: dsd_edge_states(p, 16, seed=8)
              for p in ("fast_bins4", "high_mono")}
    for profile, sts in states.items():
        (g,) = group_dsd(sts)
        t = group_tensors(g, torch.device("cpu"))
        width = int(g.arrays["nbytes"].max())
        assert t["data"].shape[1] == -(-width // 4) * 4 > width
        variants = [t["data"][:, :width],
                    torch.nn.functional.pad(t["data"][:, :width],
                                            (0, 8), value=0xFF),
                    t["data"]]
        outs = []
        for data in variants:
            if g.prof.mode == 1:
                outs.append(dsd_fast_decode_bytes(
                    data, t["nbytes"], t["summed"], t["value0"], t["nvals"],
                    bins=g.prof.bins, mono=g.prof.mono, nsteps=g.nsteps))
            else:
                outs.append(dsd_high_decode_bytes(
                    data, t["nbytes"], t["ptable"], t["filters"],
                    t["value0"], t["nsamples"], mono=g.prof.mono,
                    nsteps=g.nsteps))
        for other in outs[1:]:
            for w, o in zip(outs[0], other):
                assert torch.equal(w, o), profile
