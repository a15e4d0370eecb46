"""wvpk_torch's plain encode scans, packer and CRC vs wvpk's: the XLA scans
of wvpk/ops/encode_kernels.py and (one case each) the Pallas encode
kernels in interpret mode, on the same random inputs (numpy, seeded from
fixed numbers). Integer codec: every comparison is exact (tolerance 0).

The port's slot layout (five slots a step, ops/encode_kernels.py) is
converted to wvpk's segments (segment A as two uint64 halves, segment B)
here, in numpy."""

import numpy as np
import pytest
import torch

from wvpk.engine.device_encoder import _final_flush as jax_final_flush
from wvpk.engine.device_encoder import pack_segments as jax_pack_segments
from wvpk.ops.encode_kernels import decorr_invert_warm as jax_invert
from wvpk.ops.encode_kernels import entropy_encode_words as jax_words
from wvpk.ops.encode_kernels import hybrid_encode_scan as jax_hybrid
from wvpk.testgen.encoder import _crc_fast
from wvpk_torch.ops.encode_cuda import decorr_invert_cuda, \
    encode_words_cuda, encode_words_plain, hybrid_encode_cuda, \
    hybrid_encode_plain
from wvpk_torch.ops.encode_kernels import decorr_invert_warm, \
    entropy_encode_words, hybrid_encode_scan
from wvpk_torch.ops.encode_pack import finish_crc, hybrid_crc_acc, \
    pack_segments_device, payload_bytes, segment_total_bits
from wvpk_torch.ops.encode_select import hybrid_scan_any, invert_any, \
    words_any

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
