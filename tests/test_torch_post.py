"""wvpk_torch's plain fixup (float arm, hybrid clip), wvx injection and
fixed-point log2/exp2 vs wvpk's, on the same random inputs (numpy,
seeded), also on the wvx edge lanes; the closed form of the getbits
counter that csrc/wvx.cu rests on. Integer codec: every comparison is
exact (tolerance 0)."""

import numpy as np
import pytest
import torch

from wvpk.ops.bitio import exp2s_v as jax_exp2s_v
from wvpk.ops.bitio import mylog2_v as jax_mylog2_v
from wvpk.ops.post import fixup as jax_fixup
from wvpk.ops.post import wvx_inject as jax_wvx_inject
from wvpk_torch.ops.bitio import exp2s_v, mylog2_v
from wvpk_torch.ops.post import fixup, wvx_inject
from wvpk_torch.ops.post_select import wvx_inject_any
from wvpk_torch.ops.wvx_cuda import int64_lanes, wvx_inject_cuda
from wvpk_torch.testgen.edge import WVX_EXTREMES, wvx_edge_lanes

from test_torch_cuda import wvx_inputs


def tt(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_float_arm_matches_xla():
    """FloatUtils.cs:32-56: shifts of both signs, 0, and the +/-32 ends
    of the host clamp (C#'s mod-32 shift makes 32 a no-op), then the
    24-bit clip."""
    T, L = 40, 9
    rng = np.random.default_rng(1)
    out = rng.integers(-2**23, 2**23, (T, L, 2)).astype(np.int32)
    out[0, :, 0] = [2**31 - 1, -2**31, 0, 1, -1, 2**23, -2**23 - 1, 5, -5]
    fsh = np.asarray([-32, -31, -5, -1, 0, 3, 10, 31, 32], np.int32)
    shift, bs = np.zeros(L, np.int32), np.full(L, 3, np.int32)
    zod = np.zeros((L, 3), np.int32)
    want = jax_fixup(out, shift, bs, fsh, zod, is_float=True,
                     int32_expand=False, hybrid=False)
    got = fixup(*tt(out, shift, bs, fsh, zod), is_float=True,
                int32_expand=False, hybrid=False)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("bytes_stored", [0, 1, 2, 3])
def test_hybrid_clip_matches_xla(bytes_stored):
    """The hybrid clip to the stored width (UnpackUtils.cs:1350-1393),
    with shifts, on values past both ends of the range."""
    T, L = 48, 8
    rng = np.random.default_rng(10 + bytes_stored)
    lim = 1 << (8 * (bytes_stored + 1) - 1)
    out = rng.integers(-2 * lim, 2 * lim, (T, L, 2)).clip(
        -2**31, 2**31 - 1).astype(np.int32)
    shift = np.asarray([0, 1, 3, 7, 0, 2, 5, 0], np.int32)
    bs = np.full(L, bytes_stored, np.int32)
    fsh = np.zeros(L, np.int32)
    zod = np.tile(np.asarray([2, 0, 0], np.int32), (L, 1))
    for expand in (False, True):
        want = jax_fixup(out, shift, bs, fsh, zod, is_float=False,
                         int32_expand=expand, hybrid=True)
        got = fixup(*tt(out, shift, bs, fsh, zod), is_float=False,
                    int32_expand=expand, hybrid=True)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("C", [1, 2], ids=["mono_false_stereo", "stereo"])
def test_wvx_inject_matches_xla(C):
    """Random sent_bits 0-8, old-style and max_width streams, every
    re-expansion arm, short lanes; the mono case has FALSE_STEREO lanes
    (the second pass over zeros)."""
    (out, ns, words, sbit, sbc, sent, mw, zod, fs) = wvx_inputs(5, 48, 12, C)
    fs_arg = fs if fs.any() else None
    want = jax_wvx_inject(out, ns, words.view(np.uint32), sbit, sbc, sent,
                          mw, zod, false_stereo=fs_arg)
    got = wvx_inject(*tt(out, ns, words, sbit, sbc, sent, mw, zod),
                     None if fs_arg is None else torch.from_numpy(fs))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert (C == 2) or fs.any()
    same = wvx_inject_any(*tt(out, ns, words, sbit, sbc, sent, mw, zod),
                          None if fs_arg is None else torch.from_numpy(fs))
    for w, g in zip(got, same):
        assert torch.equal(w, g)


def _btr(seq, sb, mw):
    """The bits each value of `seq` (int64) takes from the wvx stream, 0
    where it reads none, and whether max_width truncated it."""
    pv = np.where(seq < 0, ~seq, seq)
    width = np.frexp(pv.astype(np.float64))[1].astype(np.int64) + sb
    trunc = (mw > 0) & (width > mw)
    btr = np.where(trunc, sb - (width - mw), sb)
    return np.where((sb > 0) & (~trunc | (btr > 0)), btr, 0), trunc


def _closed_bc(start_bc, P):
    """The getbits counter before each value from the prefix sums P of
    the bits read before it (csrc/wvx.cu's closed form)."""
    return np.where(start_bc >= P, start_bc - P, (start_bc - P) % 8)


def _lane_sequence(out, ns, fs, lane):
    """A lane's valid values in interleaved order, then the FALSE_STEREO
    pass's zeros; and the count of the stored ones."""
    T, _L, C = out.shape
    nt = min(max(int(ns[lane]), 0), T)
    vals = out[:nt, lane].reshape(-1).astype(np.int64)
    nfs = nt if fs is not None and fs[lane] else 0
    return np.concatenate([vals, np.zeros(nfs, np.int64)]), nt * C


@pytest.mark.parametrize("mono", [False, True],
                         ids=["stereo", "mono_false_stereo"])
def test_wvx_edge_lanes_plain_matches_xla(mono):
    """The port's plain scan equals wvpk's on every kind of edge lane
    (testgen/edge.py::wvx_edge_lanes), with the FALSE_STEREO lanes of
    the mono set."""
    out, ns, words, sbit, sbc, sent, mw, zod, fs = wvx_edge_lanes(
        64, seed=0, mono=mono)
    fs_arg = fs if fs.any() else None
    assert mono == (fs_arg is not None)
    want = jax_wvx_inject(out, ns, words.view(np.uint32), sbit, sbc, sent,
                          mw, zod, false_stereo=fs_arg)
    got = wvx_inject(*tt(out, ns, words, sbit, sbc, sent, mw, zod),
                     None if fs_arg is None else torch.from_numpy(fs))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("mono", [False, True],
                         ids=["stereo", "mono_false_stereo"])
def test_wvx_edge_lanes_reach_every_case(mono):
    """The edge lanes reach what the corpus never does: every sent_bits
    class, truncations to fewer bits and to none, start_bc of 0, 3, 7-40
    and below 0, cursors past the row's last word, every re-expansion
    arm, the int32 extremes, counts of 0 and T and between, FALSE_STEREO
    lanes (mono) and lanes outside the kernel's 32-bit cursor range."""
    out, ns, words, sbit, sbc, sent, mw, zod, fs = wvx_edge_lanes(
        64, seed=0, mono=mono)
    T, L, C = out.shape
    W = words.shape[1]
    cases = set()
    for lane in range(L):
        seq, _nv = _lane_sequence(out, ns, fs, lane)
        sb, m = int(sent[lane]), int(mw[lane])
        b, trunc = _btr(seq, sb, m)
        cases.add(("sent_bits", 0 if sb == 0 else 8 if sb <= 8 else
                   31 if sb < 32 else 32 if sb == 32 else 255
                   if sb <= 255 else "wide"))
        cases.add(("max_width", m > 0))
        if sb > 0 and (trunc & (b > 0)).any():
            cases.add("fewer_bits")
        if sb > 0 and (trunc & (b == 0)).any():
            cases.add("no_bits")
        S = int(sbc[lane])
        cases.add(("start_bc", S if S in (0, 3) else
                   "7-40" if 7 <= S <= 40 else "negative" if S < 0 else S))
        if len(seq) and int(sbit[lane]) + b.sum() > (W - 1) * 32:
            cases.add("past_row")
        z, o, d = zod[lane]
        cases.add(("arm", "zeros" if z else "ones" if o else "dups" if d
                   else "none"))
        cases.add(("ns", "0" if ns[lane] == 0 else "T" if ns[lane] == T
                   else "between"))
        cases.update(("extreme", int(x)) for x in set(seq.tolist())
                     & set(WVX_EXTREMES))
        if fs[lane]:
            cases.add("false_stereo")
    want = {("sent_bits", k) for k in (0, 8, 31, 32, 255, "wide")} \
        | {("max_width", False), ("max_width", True), "fewer_bits",
           "no_bits", "past_row"} \
        | {("start_bc", k) for k in (0, 3, "7-40", "negative")} \
        | {("arm", k) for k in ("none", "zeros", "ones", "dups")} \
        | {("ns", k) for k in ("0", "T", "between")} \
        | {("extreme", x) for x in WVX_EXTREMES} \
        | ({"false_stereo"} if mono else set())
    assert want <= cases, want - cases
    wide = int64_lanes(T, C, *tt(ns, sbit, sent),
                       torch.from_numpy(fs) if mono else None)
    assert 0 < int(wide.sum()) < L


def test_wvx_cursor_closed_form():
    """The lemma csrc/wvx.cu rests on: over random sequences of bit counts
    (0, 1-8, 9-31 and 32-300) from starts S of 0, 3 and -40..60, the
    getbits counter in closed form in the prefix sum P of the bits read
    (S - P while S >= P, else (S - P) mod 8) refills to the same bc_pre as
    the serial recurrence at every read: the same window of min(bc_pre,
    32) bits and the same counter after it, bc_pre - btr."""
    rng = np.random.default_rng(7)
    N, K = 20000, 48
    btr = np.stack([np.zeros((N, K), np.int64), rng.integers(1, 9, (N, K)),
                    rng.integers(9, 32, (N, K)),
                    rng.integers(32, 301, (N, K))])[
        rng.integers(0, 4, (N, K)), np.arange(N)[:, None], np.arange(K)]
    S = np.where(rng.random(N) < 0.5, rng.choice([0, 3], N),
                 rng.integers(-40, 61, N))
    bc, P = S.copy(), np.zeros(N, np.int64)
    reads = 0
    for k in range(K):
        b = btr[:, k]
        read = b > 0
        bc_pre = bc + (((np.maximum(b - bc, 0) + 7) >> 3) << 3)
        e = _closed_bc(S, P)
        pre = e + (((np.maximum(b - e, 0) + 7) >> 3) << 3)
        np.testing.assert_array_equal(np.minimum(bc_pre, 32)[read],
                                      np.minimum(pre, 32)[read])
        np.testing.assert_array_equal((bc_pre - b)[read], (pre - b)[read])
        bc = np.where(read, bc_pre - b, bc)
        P += b
        reads += int(read.sum())
    assert reads > N * K // 2


def test_wvx_kernel_wrapper_refuses_cpu_tensors():
    arrays = tt(*wvx_inputs(6, 8, 2, 2))
    with pytest.raises(ValueError, match="CUDA"):
        wvx_inject_cuda(*arrays)


def test_exp2s_mylog2_match_xla():
    """Over the whole table index range at every shift that matters, and
    at the edges: exp2s' int32 wrap past shift 9 and the 9-bit window of
    mylog2 on both sides of 2^9."""
    logs = np.concatenate([np.arange(-64 * 256, 64 * 256),
                           [2**31 - 1, -(2**31), 2**40, -(2**40)]])
    want = np.asarray(jax_exp2s_v(logs.astype(np.int64)))
    got = exp2s_v(torch.from_numpy(logs.astype(np.int64))).numpy()
    np.testing.assert_array_equal(want, got)
    vals = np.concatenate([np.arange(0, 1 << 17),
                           [(1 << k) + d for k in range(17, 61)
                            for d in (-1, 0, 1)]]).astype(np.int64)
    want = np.asarray(jax_mylog2_v(vals))
    got = mylog2_v(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(want, got)
