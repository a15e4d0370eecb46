"""wvpk_torch's plain encode scans, packer and CRC vs wvpk's: the XLA scans
of wvpk/ops/encode_kernels.py and (one case each) the Pallas encode
kernels in interpret mode, on the same random inputs (numpy, seeded from
fixed numbers). Integer codec: every comparison is exact (tolerance 0).

The port's slot layout (five slots a step, ops/encode_kernels.py) is
converted to wvpk's segments (segment A as two uint64 halves, segment B)
here, in numpy."""

from collections import Counter

import numpy as np
import pytest
import torch

from wvpk.engine.device_encoder import _final_flush as jax_final_flush
from wvpk.engine.device_encoder import pack_segments as jax_pack_segments
from wvpk.ops.encode_kernels import decorr_invert_warm as jax_invert
from wvpk.ops.encode_kernels import entropy_encode_words as jax_words
from wvpk.ops.encode_kernels import hybrid_encode_scan as jax_hybrid
from wvpk.testgen.encoder import _crc_fast
from wvpk.ops.encode_select import invert_any as jax_invert_any
from wvpk_torch.ops.decorr_cuda import ENCODE_CHAINS as TABLE_CHAINS
from wvpk_torch.ops.decorr_cuda import ENCODE_INSTANCES, GENERIC, \
    instance_name, lane_runs
from wvpk_torch.ops.encode_cuda import INVERT_INSTANCES, chain_kernel, \
    decorr_invert_cuda, encode_words_cuda, encode_words_plain, \
    hybrid_encode_cuda, hybrid_encode_plain, int64_lanes, invert_instance
from wvpk_torch.ops.encode_kernels import decorr_invert_warm, \
    entropy_encode_words, hybrid_encode_scan
from wvpk_torch.ops.encode_pack import finish_crc, hybrid_crc_acc, \
    pack_segments_device, payload_bytes, segment_total_bits
from wvpk_torch.ops.encode_select import hybrid_scan_any, invert_any, \
    words_any
from wvpk_torch.tables import LOG2_TABLE, exp2s
from wvpk_torch.testgen.edge import ENCODE_EDGE_CHAIN, encode_edge_lanes

# tests/test_encode_pallas.py's chains
CHAINS = [
    ((18, 17, 2), False),
    ((18, 18, 2, 17, 3), False),
    ((1, 17, -2, 8), False),
    ((-1, 18, 2), False),
    ((-3, 5, 17), False),
    ((18, 17, 3, 2, 5, 7, 18, 1, 4, 6), False),
    ((18, 17, 2), True),
    ((2, 18, 1, 17, 8), True),
]
WORD_KINDS = ["normal", "runs", "escapes", "huge"]
HYBRID_FLAGS = [(False, False), (True, False), (True, True), (False, True)]


def tt(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def segments_u64(bits, lens):
    """The port's (W, L, 5) slots -> wvpk's (segA_lo, segA_hi, segA_len,
    segB_bits, segB_len): segment A is slots 0-3 concatenated."""
    bits = np.asarray(bits, np.int64).astype(np.uint64)
    lens = np.asarray(lens, np.int64)
    lo = np.zeros(lens.shape[:2], np.uint64)
    hi = np.zeros_like(lo)
    ln = np.zeros(lens.shape[:2], np.int64)
    for k in range(4):
        b, n = bits[..., k], lens[..., k]
        b = np.where(n > 0, b, np.uint64(0))
        sh = ln.astype(np.uint64)
        lo |= np.where(ln < 64, b << np.minimum(sh, 63), np.uint64(0))
        hi |= np.where(ln >= 64, b << (np.maximum(ln - 64, 0)
                                       .astype(np.uint64)),
                       np.where(ln > 0, b >> (np.uint64(64) - np.minimum(
                           sh, 63)), np.uint64(0)))
        ln += n
    return lo, hi, ln.astype(np.int32), bits[..., 4], lens[..., 4]


def assert_segments(want, got, what):
    """wvpk's 9-tuple (segments + pending word) against the port's
    (bits, lens, pvalid, poc, pbits, pnb)."""
    names = ["segA_lo", "segA_hi", "segA_len", "segB_bits", "segB_len",
             "pvalid", "poc", "pbits", "pnb"]
    conv = list(segments_u64(got[0].numpy(), got[1].numpy())) + [
        g.numpy() for g in got[2:6]]
    for name, w, g in zip(names, want, conv):
        np.testing.assert_array_equal(
            np.asarray(w).astype(np.uint64),
            np.asarray(g).astype(np.int64).astype(np.uint64),
            err_msg=f"{what}/{name}")


def _rand_pcm(rng, T, C, mag):
    s = mag * np.sin(2 * np.pi * np.arange(T) / 71.0)
    base = np.stack([s * (0.5 + 0.5 * c) for c in range(C)], 1)
    return np.round(base + rng.normal(0, mag / 30, (T, C))).astype(np.int32)


def chain_arrays(chain, L):
    npz = len(chain)
    terms = np.zeros((L, 16), np.int32)
    deltas = np.zeros((L, 16), np.int32)
    terms[:, :npz] = chain
    deltas[:, :npz] = 2
    return terms, deltas, np.full(L, npz, np.int32)


def invert_inputs(seed, chain, mono, warm, T=96, L=5):
    rng = np.random.default_rng(seed)
    C = 1 if mono else 2
    targ = np.stack([_rand_pcm(rng, T, C, 1 << (10 + i)) for i in range(L)],
                    axis=1)
    terms, deltas, nt = chain_arrays(chain, L)
    if warm:
        w0a = rng.integers(-900, 900, (L, 16)).astype(np.int64)
        w0b = rng.integers(-900, 900, (L, 16)).astype(np.int64)
        h0a = rng.integers(-(1 << 14), 1 << 14, (L, 16, 8)).astype(np.int64)
        h0b = rng.integers(-(1 << 14), 1 << 14, (L, 16, 8)).astype(np.int64)
    else:
        w0a = w0b = np.zeros((L, 16), np.int64)
        h0a = h0b = np.zeros((L, 16, 8), np.int64)
    return targ, terms, deltas, nt, w0a, w0b, h0a, h0b


@pytest.mark.parametrize("k", range(len(CHAINS)),
                         ids=[f"{c}{'_mono' if m else ''}" for c, m in CHAINS])
@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warm"])
def test_invert_matches_xla(k, warm):
    chain, mono = CHAINS[k]
    args = invert_inputs(100 + 2 * k + warm, chain, mono, warm)
    want, wstate = jax_invert(*args, mono=mono, with_state=True)
    got, gstate = decorr_invert_warm(*tt(*args), mono=mono, with_state=True)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    for w, g in zip(wstate, gstate):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert torch.equal(invert_any(*tt(*args), mono=mono), got)


def words_inputs(seed, kind, mono, W=160, L=4):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        r = rng.normal(0, 600, (W, L))
    elif kind == "runs":
        r = rng.normal(0, 3, (W, L)).round()
        r[rng.random((W, L)) < 0.7] = 0
        r[: W // 4] = 0                       # leading run
    elif kind == "escapes":
        r = rng.normal(0, 50, (W, L))
        big = rng.random((W, L)) < 0.05
        r = np.where(big, rng.integers(1 << 20, 1 << 26, (W, L)), r)
    else:
        r = rng.integers(-(1 << 26), 1 << 26, (W, L))
    res = np.asarray(r, np.int64).astype(np.int32)
    med0 = np.zeros((L, 2, 3), np.int64)
    for i in range(L):
        for c in range(1 if mono else 2):
            base = [0, 3, 9, 1 << 18][i % 4]
            med0[i, c] = sorted(rng.integers(base, base * 4 + 4, 3))
    nvals = np.asarray([W, W - 1, W // 2, 3], np.int32)[:L]
    return res, med0, nvals


@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
@pytest.mark.parametrize("kind", WORD_KINDS)
def test_words_match_xla(kind, mono):
    args = words_inputs(200 + 2 * WORD_KINDS.index(kind) + mono, kind, mono)
    want = jax_words(*args, mono=mono)
    got = entropy_encode_words(*tt(*args), mono=mono)
    assert_segments(want, got, kind)


def hybrid_inputs(seed, chain, mono, T=80, L=4):
    rng = np.random.default_rng(seed)
    C = 1 if mono else 2
    targ = np.stack([_rand_pcm(rng, T, C, 1 << (9 + 2 * i))
                     for i in range(L)], axis=1)
    targ[:12, 0] = 0                        # run-gate gamma(0) arm
    terms, deltas, nt = chain_arrays(chain, L)
    med0 = np.zeros((L, 2, 3), np.int64)
    for i in range(L):
        for c in range(2):
            med0[i, c] = sorted(rng.integers(1, 600, 3))
    slow0 = rng.integers(0, 3000, (L, 2)).astype(np.int64)
    acc0 = (rng.integers(1, 40, (L, 2)) << 16).astype(np.int64)
    delta0 = rng.integers(1, 3, (L, 2)).astype(np.int64)
    nvals = np.asarray([T * C, T * C - 1, T * C // 2, 5], np.int32)[:L]
    z16 = np.zeros((L, 16), np.int64)
    z168 = np.zeros((L, 16, 8), np.int64)
    return (targ, terms, deltas, nt, med0, slow0, acc0, delta0, nvals, z16,
            z16, z168, z168)


@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
@pytest.mark.parametrize("flags", HYBRID_FLAGS,
                         ids=["plain", "bitrate", "bitrate_balance",
                              "balance_flag_alone"])
def test_hybrid_scan_matches_xla(flags, mono):
    bitrate, balance = flags
    chain = (18, 17, 2) if mono else (1, 17, -2, 8)
    args = hybrid_inputs(300 + 2 * HYBRID_FLAGS.index(flags) + mono, chain,
                         mono)
    kw = dict(mono=mono, hybrid_bitrate=bitrate, hybrid_balance=balance)
    want = jax_hybrid(*args, **kw)
    got = hybrid_encode_scan(*tt(*args), **kw)
    assert_segments(want[:9], got[:6], f"hybrid {flags}")
    np.testing.assert_array_equal(np.asarray(want[9]), got[6].numpy())


def test_invert_matches_pallas_interpret():
    from wvpk.ops.encode_pallas import decorr_invert_pallas

    chain = (1, 17, -2, 8)
    targ, terms, deltas, nt, *seeds = invert_inputs(7, chain, False, True,
                                                    T=40, L=3)
    want, wstate = decorr_invert_pallas(
        targ, deltas, *seeds, mono=False, static_terms=chain,
        interpret=True, with_state=True)
    got, gstate = decorr_invert_warm(*tt(targ, terms, deltas, nt, *seeds),
                                     mono=False, with_state=True)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    for w, g in zip(wstate, gstate):
        np.testing.assert_array_equal(np.asarray(w)[:, :len(chain)],
                                      g.numpy()[:, :len(chain)])


def test_words_match_pallas_interpret():
    from wvpk.ops.encode_pallas import entropy_encode_pallas

    args = words_inputs(8, "runs", False, W=64)
    want = entropy_encode_pallas(*args, mono=False, interpret=True)
    assert_segments(want, entropy_encode_words(*tt(*args), mono=False),
                    "pallas runs")


def test_hybrid_matches_pallas_interpret():
    from wvpk.ops.encode_pallas import hybrid_encode_pallas

    chain = (18, 17, 2)
    args = hybrid_inputs(9, chain, False, T=24, L=2)
    kw = dict(mono=False, hybrid_bitrate=True, hybrid_balance=True)
    targ, _terms, deltas, _nt, *rest = args
    want = hybrid_encode_pallas(targ, deltas, *rest, static_terms=chain,
                                interpret=True, **kw)
    got = hybrid_encode_scan(*tt(*args), **kw)
    assert_segments(want[:9], got[:6], "pallas hybrid")
    np.testing.assert_array_equal(np.asarray(want[9]), got[6].numpy())


@pytest.mark.parametrize("kind", ["runs", "escapes"])
def test_device_packer_matches_host_pack_segments(kind):
    """The payload of pack_segments_device (slots and the final flush
    packed in tensor ops) against wvpk's host packer over the same
    segments with wvpk's BitWriter tails, byte for byte, and the bit
    totals."""
    res, med0, nvals = words_inputs(10 + len(kind), kind, False, W=300, L=4)
    bits, lens, *pending = entropy_encode_words(*tt(res, med0, nvals),
                                                mono=False)
    words, total = pack_segments_device(bits, lens, *pending)
    got = payload_bytes(words, total)
    segs = segments_u64(bits.numpy(), lens.numpy())
    tails = jax_final_flush(*(p.numpy() for p in pending))
    assert got == jax_pack_segments(*segs, tails)
    tail_bits = np.asarray([n for _, n in tails])
    np.testing.assert_array_equal(
        total.numpy(), segment_total_bits(lens).numpy() + tail_bits)
    w2, t2 = encode_words_plain(*tt(res, med0, nvals), mono=False)
    assert torch.equal(w2, words) and torch.equal(t2, total)
    w3, t3 = words_any(*tt(res, med0, nvals), mono=False)
    assert torch.equal(w3, words) and torch.equal(t3, total)


@pytest.mark.parametrize("mono,joint", [(False, True), (False, False),
                                        (True, False)],
                         ids=["joint", "stereo", "mono"])
def test_crc_acc_matches_crc_fast(mono, joint):
    """hybrid_crc_acc + finish_crc == testgen's _crc_fast over each
    lane's first nvals decoded values (joint stereo undone), full-range
    int32 values included."""
    rng = np.random.default_rng(20 + 2 * mono + joint)
    C = 1 if mono else 2
    T, L = 700, 5
    recon = rng.integers(-2**31, 2**31, (T, L, C)).astype(np.int32)
    nvals = np.asarray([T * C, T * C - C, 7 * C, C, 0], np.int32)
    acc = hybrid_crc_acc(*tt(recon, nvals), joint=joint, mono=mono).numpy()
    for i in range(L):
        final = recon[:nvals[i] // C, i].astype(np.int64)
        if joint:
            r = (final[:, 1] - (final[:, 0] >> 1)).astype(np.int32)
            final = np.stack([(final[:, 0] + r).astype(np.int32), r], 1)
        assert finish_crc(int(acc[i]), int(nvals[i])) == _crc_fast(final)


def test_hybrid_plain_packs_the_scan():
    """hybrid_encode_plain (the kernel's contract) = the scan packed with
    its final flush, and hybrid_scan_any takes it on the CPU."""
    args = tt(*hybrid_inputs(11, (18, 17, 2), False, T=40, L=3))
    kw = dict(mono=False, hybrid_bitrate=True, hybrid_balance=False)
    scan = hybrid_encode_scan(*args, **kw)
    words, total, recon = hybrid_encode_plain(*args, **kw)
    w2, t2 = pack_segments_device(*scan[:6])
    assert torch.equal(words, w2) and torch.equal(total, t2)
    assert torch.equal(recon, scan[6])
    for a, b in zip(hybrid_scan_any(*args, **kw), (words, total, recon)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["invert", "words", "hybrid"])
def test_kernel_wrappers_refuse_cpu_tensors(name):
    if name == "invert":
        call = lambda: decorr_invert_cuda(  # noqa: E731
            *tt(*invert_inputs(1, (18, 17, 2), False, False, T=8, L=2)),
            mono=False)
    elif name == "words":
        call = lambda: encode_words_cuda(  # noqa: E731
            *tt(*words_inputs(1, "normal", False, W=8, L=2)), mono=False)
    else:
        call = lambda: hybrid_encode_cuda(  # noqa: E731
            *tt(*hybrid_inputs(1, (18, 17, 2), False, T=8, L=2)),
            mono=False, hybrid_bitrate=True, hybrid_balance=False)
    with pytest.raises(ValueError, match="CUDA"):
        call()


# ---------------------------------------------------------------------------
# encode edge lanes (testgen/edge.py::encode_edge_lanes)
# ---------------------------------------------------------------------------

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def _wrap(x):
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def _mylog2(av):
    """mylog2 on any int64 value, as the coders take it."""
    av += av >> 9
    d = av.bit_length() if av > 0 else 0
    return (d << 8) + LOG2_TABLE[(av >> (d - 9) if d >= 9 else av << (9 - d))
                                 & 0xFF]


class _Branches:
    """A scalar walk of one lane's word coder (WordsUtils.cs:272-511 run
    forward, and the hybrid error limit and search), counting the branches
    the encode edge lanes must reach."""

    def __init__(self, counts, med0, mono):
        self.n = counts
        self.mono = mono
        self.med = [[int(x) for x in med0[c]] for c in range(2)]
        self.pvalid, self.poc = False, 0
        flat = [x for m in self.med for x in m]
        self.n["int64_body"] += any(x != _wrap(x) for x in flat)
        self.n["median_zero"] += any(x == 0 for x in flat)
        self.n["median_max32"] += any(x == I32_MAX for x in flat)

    def tiny(self):
        return not self.pvalid and (self.med[0][0] & ~1) == 0 \
            and (self.med[1][0] & ~1) == 0

    def coded(self, c, r):
        """A coded word of channel c: its ones count and its interval's
        (low, width); the medians and the holding state move on."""
        self.n["int32_extreme"] += r in (I32_MIN, I32_MAX)
        av = ~r if r < 0 else r
        m = self.med[c]
        g0, g1 = (m[0] >> 4) + 1, (m[1] >> 4) + 1
        g2 = max((m[2] >> 4) + 1, 1)
        if av < g0:
            oc, low, width = 0, 0, g0
        elif av < g0 + g1:
            oc, low, width = 1, g0, g1
        else:
            q = (av - g0 - g1) // g2
            oc, low, width = 2 + q, g0 + g1 + q * g2, g2
            self.n[f"quotient_{min(q, 4)}"] += 1
            self.n["quotient_escape"] += oc >= 8
        new = [m[0] - ((m[0] + 126) >> 7) * 2 if oc == 0
               else m[0] + ((m[0] + 128) >> 7) * 5,
               m[1] if oc == 0 else m[1] - ((m[1] + 62) >> 6) * 2 if oc == 1
               else m[1] + ((m[1] + 64) >> 6) * 5,
               m[2] if oc < 2 else m[2] - ((m[2] + 30) >> 5) * 2 if oc == 2
               else m[2] + ((m[2] + 32) >> 5) * 5]
        self.n["median_wraps"] += any(x != _wrap(x) for x in new)
        self.med[c] = [_wrap(x) for x in new]
        if self.pvalid:
            self.flush(2 * self.poc + (oc != 0))
        self.poc = oc - 1 if self.pvalid else oc
        self.pvalid = not (self.pvalid and oc == 0)
        return oc, low, width

    def flush(self, raw):
        if raw >= 16:
            self.n["escape"] += 1
            self.n["escape_gamma_over_32_bits"] += raw - 16 >= 1 << 16

    def finish(self):
        if self.pvalid:
            self.flush(2 * self.poc)


def _lane_counts(n, nv, W, mono):
    n["nvals_zero"] += nv == 0
    n["nvals_odd"] += nv % 2 == 1
    n["nvals_full"] += nv == W


def words_branches(res, med0, nvals, mono):
    n = Counter()
    W, L = res.shape
    for lane in range(L):
        nv = min(max(int(nvals[lane]), 0), W)
        _lane_counts(n, nv, W, mono)
        s = _Branches(n, med0[lane], mono)
        col = [int(x) for x in res[:, lane]]
        zacc = 0
        for w in range(nv):
            c = 0 if mono else w & 1
            if s.tiny():
                if zacc > 0:
                    zacc -= 1
                    if zacc > 0:
                        continue
                else:
                    z = 0
                    while w + z < nv and col[w + z] == 0:
                        z += 1
                    if z > 0:
                        n["run"] += 1
                        n["run_starts_on_b"] += c == 1
                        n["run_crosses_tile"] += w // 32 != (w + z - 1) // 32
                        n["run_to_end"] += w + z == nv
                        zacc = z
                        s.med = [[0] * 3, [0] * 3]
                        continue
            s.coded(c, col[w])
        s.finish()
    return n


def _exp2s(log):
    return exp2s(log) if abs(log) < (40 << 8) else 0


def hybrid_branches(args, mono, bitrate, balance):
    """The branch counts of the hybrid edge lanes whose chain is the
    identity (zero weights and deltas: residual = target)."""
    (targ, _t, deltas, _nt, med0, slow0, acc0, delta0, nvals,
     w0a, *_rest) = args
    n = Counter()
    T, L, C = targ.shape
    for lane in range(L):
        if deltas[lane].any() or w0a[lane].any():
            continue
        nv = int(nvals[lane])
        _lane_counts(n, nv, T * C, mono)
        s = _Branches(n, med0[lane], mono)
        slow = [int(x) for x in slow0[lane]]
        acc = [int(x) for x in acc0[lane]]
        err = [0, 0]
        for t in range(T):
            for c in range(C):
                if t * C + c >= nv:
                    continue
                n["run_gate"] += s.tiny()
                if c == 0:
                    acc = [a + int(d) for a, d in zip(acc, delta0[lane])]
                    br = [_wrap(a >> 16) for a in acc][:C]
                    slog = [(x + 128) >> 8 for x in slow]
                    if bitrate and balance and not mono:
                        bal = (slog[1] - slog[0] + br[1] + 1) >> 1
                        n["balance_hi"] += bal > br[0]
                        n["balance_lo"] += -bal > br[0]
                        br = [0, br[0] * 2] if bal > br[0] else \
                            [br[0] * 2, 0] if -bal > br[0] else \
                            [br[0] - bal, br[0] + bal]
                    for k in range(C):
                        e = slog[k] - br[k] + 0x100 if bitrate else br[k]
                        if bitrate and e <= 0:
                            n["slow_log_low"] += 1
                            err[k] = 0
                            continue
                        n["exp2s_shift_over_9"] += abs(e) >> 8 > 9
                        err[k] = _exp2s(e)
                r = int(targ[t, lane, c])
                oc, low, width = s.coded(c, r)
                av = ~r if r < 0 else r
                e = err[c]
                lo, hi = low, low + width - 1
                if e == 0:
                    n["limit_zero"] += 1
                    mid = av
                else:
                    n["limit_negative"] += e < 0
                    n["limit_above_interval"] += 0 < hi - lo <= e
                    steps = 0
                    mid = (hi + lo + 1) >> 1
                    while steps < 32 and hi - lo > e:
                        if av >= mid:
                            lo = mid
                        else:
                            hi = mid - 1
                        mid = (hi + lo + 1) >> 1
                        steps += 1
                    n["search_32_steps"] += steps == 32
                if bitrate:
                    slow[c] = slow[c] - ((slow[c] + 128) >> 8) + _mylog2(mid)
        s.finish()
    return n


_WORD_BRANCHES = ("nvals_zero", "nvals_odd", "nvals_full", "int32_extreme",
                  "median_zero", "median_max32", "median_wraps",
                  "int64_body", "quotient_0", "quotient_1", "quotient_2",
                  "quotient_3", "quotient_escape", "escape",
                  "escape_gamma_over_32_bits")
EDGE_CASES = {
    "words": (None, _WORD_BRANCHES + (
        "run", "run_starts_on_b", "run_crosses_tile", "run_to_end")),
    "words_mono": (None, _WORD_BRANCHES + (
        "run", "run_crosses_tile", "run_to_end")),
    "hybrid_plain": ((False, False), _WORD_BRANCHES + (
        "run_gate", "limit_zero", "limit_negative", "limit_above_interval",
        "search_32_steps", "exp2s_shift_over_9")),
    "hybrid_bitrate": ((True, False), _WORD_BRANCHES + (
        "run_gate", "limit_above_interval", "slow_log_low",
        "exp2s_shift_over_9")),
    "hybrid_bitrate_balance": ((True, True), _WORD_BRANCHES + (
        "run_gate", "limit_above_interval", "slow_log_low", "balance_hi",
        "balance_lo")),
    "hybrid_mono_plain": ((False, False), _WORD_BRANCHES + (
        "run_gate", "limit_zero", "limit_negative", "limit_above_interval",
        "search_32_steps")),
    "hybrid_mono_bitrate": ((True, False), _WORD_BRANCHES + (
        "run_gate", "limit_above_interval", "slow_log_low")),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_encode_edge_lanes_plain_matches_xla(case):
    """The port's plain word coders against wvpk's XLA scans on the 64
    encode edge lanes of each kind (and hybrid profile), exact, with a
    scalar walk of the lanes counting every branch the lanes must reach:
    residuals at INT32_MIN/MAX, zero runs from a stereo pair's second
    word, across the 32-word staging tiles and to the lane's end, escapes
    whose gamma passes 32 bits, medians at 0, at 2^31 - 1, wrapping and
    past int32, quotients 0-3 and escape-sized, error limits of 0,
    negative and above the interval, 32-step searches, both balance
    clamps, slow_log - br <= -0x100, exp2s shifts past 9, word counts of
    0, odd and full."""
    flags, need = EDGE_CASES[case]
    kind = case if flags is None else (
        "hybrid_mono" if case.startswith("hybrid_mono") else "hybrid")
    mono = kind.endswith("_mono")
    args = encode_edge_lanes(kind, 64, seed=5)
    if flags is None:
        want = jax_words(*args, mono=mono)
        got = entropy_encode_words(*tt(*args), mono=mono)
        assert_segments(want, got, case)
        counts = words_branches(*args, mono)
    else:
        kw = dict(mono=mono, hybrid_bitrate=flags[0], hybrid_balance=flags[1])
        want = jax_hybrid(*args, **kw)
        got = hybrid_encode_scan(*tt(*args), **kw)
        assert_segments(want[:9], got[:6], case)
        np.testing.assert_array_equal(np.asarray(want[9]), got[6].numpy())
        assert (args[1][:, :len(ENCODE_EDGE_CHAIN)] == ENCODE_EDGE_CHAIN).all()
        counts = hybrid_branches(args, mono, *flags)
    missing = [b for b in need if counts[b] == 0]
    assert not missing, f"{case}: branches not reached: {missing} ({counts})"


@pytest.mark.parametrize("static_terms", [(18, 17, 2), (5, 1), ()],
                         ids=["table_chain", "outside", "empty"])
def test_hybrid_plain_takes_and_ignores_static_terms(static_terms):
    """static_terms picks a kernel on the card and changes no result: the
    CPU path (hybrid_scan_any -> hybrid_encode_plain) gives the same
    outputs with and without it."""
    args = tt(*hybrid_inputs(12, (18, 17, 2), False, T=30, L=3))
    kw = dict(mono=False, hybrid_bitrate=True, hybrid_balance=False)
    want = hybrid_encode_plain(*args, **kw)
    for fn in (hybrid_encode_plain, hybrid_scan_any):
        for a, b in zip(fn(*args, static_terms=static_terms, **kw), want):
            assert torch.equal(a, b)


def test_int64_lanes_names_medians_past_int32():
    """The lanes the word coders run with int64 medians: those with a
    median outside int32, in either channel; 2^31 - 1 and -2^31 stay in
    the 32-bit body."""
    med0 = np.zeros((6, 2, 3), np.int64)
    med0[1, 0, 0] = (1 << 31) - 1
    med0[2, 1, 2] = 1 << 31
    med0[3, 0, 1] = -(1 << 31)
    med0[4, 1, 0] = -(1 << 31) - 1
    med0[5, 0, 2] = 1 << 40
    got = int64_lanes(torch.from_numpy(med0)).tolist()
    assert got == [False, False, True, False, True, True]


@pytest.mark.parametrize("preset,mono", [("default", False), ("fast", True),
                                         ("high", False)])
def test_scan_lanes_names_the_spec_chain(monkeypatch, preset, mono):
    """The device encoder hands the hybrid scan its spec's chain as
    static_terms (every lane carries it), as wvpk's device encoder does."""
    from wvpk_torch.encode import build_spec
    from wvpk_torch.engine import device_encoder as de

    seen = []

    def spy(*args, static_terms=None, **kw):
        seen.append(static_terms)
        return hybrid_scan_any(*args, static_terms=static_terms, **kw)

    monkeypatch.setattr(de, "hybrid_scan_any", spy)
    rng = np.random.default_rng(13)
    pcm = np.round(rng.normal(0, 900, (700, 1 if mono else 2))).astype(
        np.int64)
    spec = build_spec(pcm, block_samples=256, hybrid=True, bitrate=400,
                      preset=preset)
    de.scan_lanes(de.stage_lanes(pcm, spec, 64, torch.device("cpu")))
    assert seen == [tuple(spec.terms)] and len(spec.terms) > 0


# the chains of the static_terms tests: each of CHAINS (the CUDA invert's
# compiled kernels), a stereo and a mono chain outside it, and a mono chain
# with cross terms (wvpk leaves that one to its XLA scan)
STATIC_CHAINS = list(TABLE_CHAINS) + [
    ("outside", False, (5, 1, -3, 17)), ("outside_mono", True, (5, 1, 17)),
    ("cross_mono", True, (18, -1, 17, -2, 3))]


@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warm"])
@pytest.mark.parametrize("k", range(len(STATIC_CHAINS)),
                         ids=[name for name, _m, _t in STATIC_CHAINS])
def test_invert_any_static_terms_matches_wvpk(k, warm):
    """The port's invert_any takes wvpk's static_terms and returns what
    wvpk's invert_any returns with them, the residuals alone and with the
    final state. wvpk runs with encode_kernel="pallas": its Pallas invert
    (interpret mode on the CPU) for every static chain but a mono one with
    cross terms, which takes its XLA scan. Seeds: zeros ("fresh") or
    random in the chain's slots and zeros past it (the Pallas kernel
    returns zeros there, the port the seeds). Without static_terms the
    port gives the same residuals."""
    from wvpk.config import set_options

    _name, mono, chain = STATIC_CHAINS[k]
    targ, terms, deltas, nt, *seeds = invert_inputs(
        400 + 2 * k + warm, chain, mono, warm, T=64, L=8)
    for a in seeds:
        a[:, len(chain):] = 0
    args = (targ, terms, deltas, nt, *seeds)
    kw = dict(mono=mono, static_terms=chain)
    try:
        set_options(encode_kernel="pallas")
        want = jax_invert_any(*args, **kw)
        want_res, want_state = jax_invert_any(*args, with_state=True, **kw)
    finally:
        set_options(encode_kernel="auto")
    got = invert_any(*tt(*args), **kw)
    got_res, got_state = invert_any(*tt(*args), with_state=True, **kw)
    blind = invert_any(*tt(*args), mono=mono)
    for w, g in ((want, got), (want_res, got_res), (want, blind)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    for w, g in zip(want_state, got_state):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


# static_terms -> the kernel decorr_invert_cuda launches: each chain of
# ENCODE_CHAINS its own, any other (outside the table, mono with cross terms,
# empty, None) the run-time kernel
INVERT_RUNS = [(t, m, name) for name, m, t in TABLE_CHAINS] + [
    ((18, 17, 2, 1), False, "generic"), ((5, 1), True, "generic_mono"),
    ((18, 18, 18, -2, 2, 3, 5, -1, 17, 4), True, "generic_mono"),
    ((17, -1), True, "generic_mono"), ((), False, "generic"),
    (None, False, "generic"), (None, True, "generic_mono")]


@pytest.mark.parametrize("with_state", [False, True], ids=["main", "state"])
@pytest.mark.parametrize("static_terms,mono,ran", INVERT_RUNS)
def test_invert_cuda_runs_the_chain_kernel(static_terms, mono, ran,
                                           with_state):
    """The kernel decorr_invert_cuda launches for a static_terms, by the
    wrapper's own choice: encode_cuda.chain_kernel, the helper the wrapper
    (and hybrid_encode_cuda) calls to unpack decorr_cuda.lane_runs, must
    give one run over all the lanes and the kernel's name, and
    invert_instance the counter the launch adds to (one of the invert's 20
    kernels). Checked here without a card: the card tests launch each
    kernel and read its counter."""
    chain, name = chain_kernel(300, mono, static_terms)
    assert lane_runs(300, mono, static_terms) == [(chain, 0, 300)]
    assert name == instance_name(chain, mono) == ran
    assert (chain == GENERIC) == ran.startswith("generic")
    key = invert_instance(name, with_state)
    assert key in INVERT_INSTANCES and key.endswith("[state]") == with_state
    assert set(hybrid_encode_cuda.chain_launches) == set(ENCODE_INSTANCES)
    assert set(decorr_invert_cuda.chain_launches) == set(INVERT_INSTANCES)
