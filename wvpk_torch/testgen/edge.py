"""Edge streams: for the entropy decoder, one bucket of one profile whose
lanes take every path of get_words (WordsUtils.cs:272-511); for the DSD
decoders, one group of one profile whose lanes take every branch of the
mode-1 and mode-3 coders (`dsd_edge_states`); for the encode word coders,
staged kernel inputs whose lanes reach every branch of the lossless and
the hybrid coder (`encode_edge_lanes`); for the correction scan and the
wvx injection, their inputs built directly (`wvc_edge_lanes` and
`wvx_edge_lanes`, at the end).

No counterpart in wvpk.testgen. Each lane is a one-block file of
EDGE_SAMPLES samples, encoded with this package's encoder and parsed back;
the lanes cycle through the kinds of EDGE_KINDS, with amplitudes that give
words of 2 to 30 bits, so words straddle the 32-bit refills of a bit reader
at every offset:

- `noise`: Gaussian noise, amplitude 2^3 .. 2^14 by lane;
- `zero_runs`: silence with short bursts and zero initial medians (zero
  runs and their Elias-gamma lengths);
- `spikes`: small noise with rare full-scale spikes (LIMIT_ONES escapes);
- `truncated`: noise whose payload is cut short, so the lane reads the
  0xff EOF fill (an EOF break, `broke`, and a short `ndec`);
- `corrupted`: noise with a run of payload bytes overwritten by random
  bytes;
- `zero_filled`: noise whose payload tail is zero bytes (long unary zeros
  past the real words).

In the wvc profiles every second `noise` lane (lane i with i % 12 == 0,
WVC_CUT_EVERY) also has its .wvc cut to its first third: the correction
scan's cursor runs past the lane's correction stream into the row's 0xff
fill, while its main stream decodes whole.

The profiles of EDGE_PROFILES are the entropy kernel's: lossless and
hybrid (plain, HYBRID_BITRATE, HYBRID_BALANCE), stereo and mono, and
hybrid with its .wvc (the `wvc=True` outputs).
"""

from __future__ import annotations

import numpy as np

from ..container import parse_blocks
from ..container.blocks import pair_wvc
from .encoder import EncodeSpec, encode_blocks

EDGE_SAMPLES = 512
EDGE_KINDS = ("noise", "zero_runs", "spikes", "truncated", "corrupted",
              "zero_filled")
_HYB = dict(hybrid=True, hybrid_bitrate=True, bitrate=300, bitrate_delta=1)
EDGE_PROFILES = {
    "lossless": dict(joint=True),
    "lossless_mono": dict(mono=True, terms=(18, 2), deltas=(2, 2)),
    "hybrid": dict(joint=True, hybrid=True, bitrate=500),
    "hybrid_bitrate": dict(joint=True, **_HYB),
    "hybrid_balance": dict(joint=True, hybrid_balance=True, **_HYB),
    "hybrid_mono": dict(mono=True, terms=(18, 2), deltas=(2, 2), **_HYB),
    "wvc": dict(joint=True, wvc=True, **_HYB),
    "wvc_mono": dict(mono=True, terms=(18, 2), deltas=(2, 2), wvc=True,
                     **_HYB),
}


def _pcm(kind: str, lane: int, ch: int, rng) -> np.ndarray:
    n = EDGE_SAMPLES
    if kind == "zero_runs":
        pcm = np.zeros((n, ch))
        for at in rng.integers(0, n - 16, 3):
            pcm[at:at + 12] = rng.normal(0, 40, (12, ch))
    elif kind == "spikes":
        pcm = rng.normal(0, 4, (n, ch))
        hit = rng.random((n, ch)) < 0.02
        pcm[hit] = rng.choice([-32000, 32000], int(hit.sum()))
    else:
        pcm = rng.normal(0, 2.0 ** (3 + lane % 12), (n, ch))
    return np.clip(np.round(pcm), -32768, 32767).astype(np.int64)


def _damage(kind: str, wvbits: bytes, rng) -> bytes:
    data = bytearray(wvbits)
    n = len(data)
    if kind == "truncated":
        return bytes(data[:int(rng.integers(n // 4, 3 * n // 4))])
    if kind == "corrupted" and n > 8:
        at = int(rng.integers(0, n - 8))
        data[at:at + 8] = rng.integers(0, 256, 8).astype(np.uint8).tobytes()
    if kind == "zero_filled":
        at = int(rng.integers(n // 2, n))
        data[at:] = bytes(n - at)
    return bytes(data)


# the lanes of a wvc profile whose .wvc is cut short: i % WVC_CUT_EVERY == 0
WVC_CUT_EVERY = 2 * len(EDGE_KINDS)


def wvc_min_bits(maxcode: np.ndarray) -> np.ndarray:
    """The fewest bits the correction scan reads on each lane of a launch
    whose maxcode is (T, L, C): a word with maxcode > 0 of bit length b
    reads b - 1 bits, and always one more where no code falls below the
    minimal-binary split (maxcode 2^b - 1, or b = 31). A lane whose .wvc
    holds fewer bits runs past its stream."""
    mc = np.asarray(maxcode, np.int64)
    b = np.zeros(mc.shape, np.int64)
    for k in range(31):
        b += mc >= 1 << k
    extra = (mc == (1 << b) - 1) | (b == 31)
    return np.where(mc > 0, b - 1 + extra, 0).sum(axis=(0, 2))


def edge_states(profile: str, lanes: int = 64, seed: int = 0) -> list:
    """Block states of `lanes` one-block files of `profile`
    (EDGE_PROFILES), lane i of kind EDGE_KINDS[i % 6]; their payloads
    damaged as the kind says, the .wvc of a wvc profile paired (and cut
    to its first third on lanes i % WVC_CUT_EVERY == 0)."""
    opts = EDGE_PROFILES[profile]
    ch = 1 if opts.get("mono") else 2
    rng = np.random.default_rng(seed)
    states = []
    for i in range(lanes):
        kind = EDGE_KINDS[i % len(EDGE_KINDS)]
        spec = EncodeSpec(
            block_samples=EDGE_SAMPLES,
            initial_medians=((0, 0, 0), (0, 0, 0)) if kind == "zero_runs"
            else None, **opts)
        sink = [] if spec.wvc else None
        blocks = parse_blocks(b"".join(encode_blocks(
            _pcm(kind, i, ch, rng), spec, wvc_sink=sink)))
        if sink is not None:
            pair_wvc(blocks, b"".join(sink))
        (st,) = [b.state for b in blocks]
        st.wvbits = _damage(kind, st.wvbits or b"", rng)
        if sink is not None and i % WVC_CUT_EVERY == 0:
            st.wvcbits = st.wvcbits[:len(st.wvcbits) // 3]
        states.append(st)
    return states


# DSD edge lanes: one-block files of a few hundred coder steps each, lane
# i of kind DSD_FAST_KINDS or DSD_HIGH_KINDS[i % n]. Mode 1:
# - `random`, `smooth`: uniform bytes; a few repeated patterns (a skewed
#   table: the interval often shrinks below the bin's total, the mult == 0
#   reset with 4 fresh bytes);
# - `truncated`, `truncated_smooth`: the payload cut at a random point, so
#   renormalisation runs out of bytes mid-step and the mult == 0 reset
#   finds fewer than 4 left;
# - `empty_row`: a bin the lane visits has its row zeroed (summed[255] ==
#   0: the lane stops with err set);
# - `past_table`: a run of 0xff payload bytes, the value driven past the
#   table (index >= summed[255]: err);
# - `past_table_first`: the initial window 0xffffffff (err at step 0);
# - `ceiling`: history bin 0's row at 255 everywhere (summed up to
#   255 x 256 = 65,280, past the parser's 1,280 a bin, so staged directly),
#   the codes encoded again with that table: a clean lane.
# Mode 3:
# - `random`, `smooth`, `truncated` as above;
# - `zeros`, `ones`: the payload's bytes all 0x00, all 0xff;
# - `wide`: staged filters outside the range the parser gives (f1..f5 in
#   [0, 2^20], |f6| <= 2^16), so the int64 body runs;
# - `wide_ptable`: a staged ptable of random int32 entries, some outside
#   [-2^30, 2^30] (the 32-bit body's ptable update), so the int64 body
#   runs;
# - `factor_extreme`: the factor near the int32 limits (its increments
#   wrap), filters otherwise in range.
# In both modes three lanes get extra payload bytes so that their byte
# counts end 1, 2 and 3 bytes before the group's row width (the payload
# padded to a multiple of 4).
DSD_EDGE_STEPS = 320
DSD_FAST_KINDS = ("random", "smooth", "truncated", "truncated_smooth",
                  "empty_row", "past_table", "past_table_first", "ceiling")
DSD_HIGH_KINDS = ("random", "smooth", "truncated", "zeros", "ones", "wide",
                  "wide_ptable", "factor_extreme")
# profile: (mode, mono, history_bits)
DSD_EDGE_PROFILES = {
    "fast_bins1": (1, False, 0), "fast_bins1_mono": (1, True, 0),
    "fast_bins4": (1, False, 2), "fast_bins4_mono": (1, True, 2),
    "fast_bins32": (1, False, 5), "fast_bins32_mono": (1, True, 5),
    "high": (3, False, None), "high_mono": (3, True, None),
}
# the filters of the `wide` lanes, by lane: (row, value) pairs
_WIDE = (((0, (1 << 20) + 1),), ((5, -(1 << 16) - 1),), ((1, -1),),
         ((4, (1 << 31) - 1), (5, 1 << 20)))


def _dsd_bytes(kind: str, n: int, ch: int, rng) -> np.ndarray:
    if kind in ("smooth", "truncated_smooth"):
        pats = rng.choice([0x55, 0xAA, 0x69, 0x96], size=(n, ch))
        return np.where(rng.random((n, ch)) < 0.9, pats,
                        rng.integers(0, 256, (n, ch)))
    return rng.integers(0, 256, (n, ch))


def _set_fast_tables(dsd, prob2: np.ndarray) -> None:
    """A mode-1 lane's tables from its probabilities, as
    container/blockstate.py::_init_dsd_fast derives them."""
    summed = np.cumsum(prob2.astype(np.uint32), axis=1)
    lookup = np.zeros(prob2.shape[0], np.int32)
    chunks, ptr = [], 0
    for b in range(prob2.shape[0]):
        if summed[b, -1]:
            lookup[b] = ptr
            chunks.append(np.repeat(np.arange(256, dtype=np.uint8), prob2[b]))
            ptr += chunks[-1].size
    dsd.probabilities = prob2.astype(np.uint8)
    dsd.summed_probabilities = summed.astype(np.uint16)
    dsd.value_lookup = lookup
    dsd.lookup_buffer = (np.concatenate(chunks) if chunks
                         else np.zeros(0, np.uint8))


def _fast_edge(kind, st, src, bins, mono, rng) -> None:
    from .dsd_encoder import _encode_fast_stream

    dsd = st.dsd
    if kind == "empty_row":
        prob2 = dsd.probabilities.copy()
        prob2[int(src[len(src) // 2]) & (bins - 1)] = 0
        _set_fast_tables(dsd, prob2)
    elif kind == "past_table":
        data = bytearray(dsd.data)
        at = len(data) // 3
        data[at:at + 6] = b"\xff" * 6
        dsd.data = bytes(data)
    elif kind == "past_table_first":
        dsd.value = 0xFFFFFFFF
    elif kind == "ceiling":
        prob2 = dsd.probabilities.copy()
        prob2[0] = 255
        _set_fast_tables(dsd, prob2)
        stream = _encode_fast_stream(
            src.tolist(), prob2, np.cumsum(prob2.astype(np.int64), axis=1),
            bins, mono)
        dsd.value = int.from_bytes(stream[:4], "big")
        dsd.data = bytes(stream[4:])


def _high_edge(kind, lane, st, rng) -> None:
    dsd = st.dsd
    if kind in ("zeros", "ones"):
        dsd.data = bytes([0 if kind == "zeros" else 0xFF]) * len(dsd.data)
    elif kind == "wide":
        dsd.filters = dsd.filters.copy()
        for row, v in _WIDE[(lane // len(DSD_HIGH_KINDS)) % len(_WIDE)]:
            dsd.filters[:, row] = v
    elif kind == "wide_ptable":
        dsd.ptable = rng.integers(-2**31, 2**31, 256).astype(np.int32)
    elif kind == "factor_extreme":
        dsd.filters = dsd.filters.copy()
        dsd.filters[0, 6] = (1 << 31) - 1 - int(rng.integers(0, 64))
        dsd.filters[1, 6] = -(1 << 31) + int(rng.integers(0, 64))


def dsd_edge_states(profile: str, lanes: int = 64, seed: int = 0) -> list:
    """Block states of `lanes` one-block DSD files of `profile`
    (DSD_EDGE_PROFILES), each DSD_EDGE_STEPS coder steps long (mode 1: a
    step a byte-value; mode 3: a step a sample), lane i of the mode's kind
    i % n, damaged or staged as the kind says."""
    from .dsd_encoder import encode_dsd_file

    mode, mono, hbits = DSD_EDGE_PROFILES[profile]
    ch = 1 if mono else 2
    kinds = DSD_FAST_KINDS if mode == 1 else DSD_HIGH_KINDS
    n = DSD_EDGE_STEPS // ch if mode == 1 else DSD_EDGE_STEPS
    kw = {} if hbits is None else {"history_bits": hbits}
    rng = np.random.default_rng(seed)
    states = []
    for i in range(lanes):
        kind = kinds[i % len(kinds)]
        src = _dsd_bytes(kind, n, ch, rng)
        (st,) = [b.state for b in parse_blocks(encode_dsd_file(
            src.astype(np.int64), mode, mono=mono, **kw))]
        if kind.startswith("truncated"):
            st.dsd.data = st.dsd.data[:int(rng.integers(
                len(st.dsd.data) // 4, 3 * len(st.dsd.data) // 4))]
        if mode == 1:
            _fast_edge(kind, st, src.reshape(-1), 1 << hbits, mono, rng)
        else:
            _high_edge(kind, i, st, rng)
        states.append(st)
    # three lanes end 1, 2 and 3 bytes before the row width
    top = (max(len(st.dsd.data) for st in states) + 2) | 3
    for k, st in enumerate(states[:3]):
        extra = top - k - len(st.dsd.data)
        st.dsd.data += rng.integers(0, 256, extra).astype(np.uint8).tobytes()
    return states


# Encode edge lanes: the inputs of one word-coder launch (ops/encode_cuda.py:
# encode_words_cuda, hybrid_encode_cuda) of ENCODE_EDGE_STEPS samples a
# lane, lane i of content kind ENCODE_VALUE_KINDS[i % 8]:
# - `noise`: Gaussian words, amplitude 2^3 .. 2^18 by lane (quotients 0-3
#   past the second median, and larger);
# - `extremes`: noise with words at INT32_MIN and INT32_MAX;
# - `silence`: zeros with short bursts, some in one channel only, and a
#   zero tail, from zero medians (zero runs that start on either word of a
#   stereo sample, cross the 32-word staging tiles and reach the lane's
#   end; the hybrid run gate);
# - `spikes`: small noise with rare spikes of 2^20 .. 2^30 from zero
#   medians (LIMIT_ONES escapes whose gamma takes more than 32 bits);
# - `med_max`: noise from medians at 2^31 - 1, the largest the 32-bit body
#   admits (their first increase wraps);
# - `med_wide`: noise from medians past int32 (the int64 body);
# - `med_zero`: noise from zero medians;
# - `ladder`: words of 1 .. 5 times the third median's interval past the
#   second (quotients 0-4 in turn).
# Hybrid lanes also take error-limit kind ENCODE_LIMIT_KINDS[i % 7], set by
# their bitrate accumulators and slow levels: `zero` (limit 0: the lossless
# code), `mid`, `high` (exp2s shifts past 9, limits above any interval),
# `negative` (negative limits without HYBRID_BITRATE: searches of 32
# steps), `slow_low` (slow_log - br <= -0x100), `balance_hi` and
# `balance_lo` (HYBRID_BALANCE's two clamps). Every hybrid lane carries
# ENCODE_EDGE_CHAIN; three in four have zero weights, deltas and rings, so
# their residuals are their targets, the rest random seeds and deltas.
# nvals: lane 0 has no words, lane 1 one fewer than full (odd in stereo),
# every eighth lane from 5 on a random count, the others full.
ENCODE_EDGE_STEPS = 320
ENCODE_EDGE_KINDS = ("words", "words_mono", "hybrid", "hybrid_mono")
ENCODE_VALUE_KINDS = ("noise", "extremes", "silence", "spikes", "med_max",
                      "med_wide", "med_zero", "ladder")
ENCODE_LIMIT_KINDS = ("zero", "mid", "high", "negative", "slow_low",
                      "balance_hi", "balance_lo")
ENCODE_EDGE_CHAIN = (18, 18, 2, 17, 3)   # the default preset's chain
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
_MED_MAX = ((_I32_MAX,) * 3, (5, _I32_MAX, 40), (_I32_MAX, 3, _I32_MAX))
_MED_WIDE = ((1 << 31, 40, 40), (7, 1 << 33, 90), (1 << 40, 1 << 35, 1 << 31))


def _enc_values(kind: str, i: int, T: int, C: int, rng) -> np.ndarray:
    if kind == "silence":
        v = np.zeros((T, C), np.int64)
        for at in rng.integers(0, T - 24, T // 12):
            n = int(rng.integers(1, 4))
            ch = slice(0, C) if rng.random() < 0.5 else slice(0, 1)
            v[at:at + n, ch] = rng.integers(-40, 41, (n, C))[:, ch]
        return v
    if kind == "spikes":
        v = np.round(rng.normal(0, 3, (T, C))).astype(np.int64)
        hit = rng.random((T, C)) < 0.03
        v[hit] = rng.integers(1 << 20, 1 << 30, int(hit.sum())) \
            * rng.choice([-1, 1], int(hit.sum()))
        return v
    if kind == "ladder":
        return np.zeros((T, C), np.int64)     # set by the caller
    amp = 2.0 ** (3 + (i // len(ENCODE_VALUE_KINDS)) % 16) \
        if kind == "noise" else 2.0 ** (8 + i % 5)
    v = np.round(rng.normal(0, amp, (T, C))).astype(np.int64)
    if kind == "extremes":
        hit = rng.random((T, C))
        v[hit < 0.04] = _I32_MIN
        v[(hit >= 0.04) & (hit < 0.08)] = _I32_MAX
    return v


def _enc_medians(kind: str, i: int, rng) -> np.ndarray:
    n = i // len(ENCODE_VALUE_KINDS)
    if kind in ("silence", "spikes", "med_zero"):
        return np.zeros((2, 3), np.int64)
    if kind == "med_max":
        return np.asarray([_MED_MAX[n % 3], _MED_MAX[(n + 1) % 3]], np.int64)
    if kind == "med_wide":
        m = np.asarray([(40, 40, 40), _MED_WIDE[n % 3]], np.int64)
        return m[::-1].copy() if n % 2 else m
    if kind == "ladder":
        return np.asarray([(0, 0, 200), (0, 0, 200)], np.int64)
    return np.sort(rng.integers(0, 1 << int(rng.integers(4, 15)), (2, 3)),
                   axis=1)


def _ladder(T: int, C: int, med: np.ndarray) -> np.ndarray:
    """Words that step the quotient past the second median through 0..4
    against the medians as they adapt: computed word by word with the
    coder's own median updates (WordsUtils.cs:433-475)."""
    m = [list(map(int, med[c])) for c in range(2)]
    v = np.zeros((T, C), np.int64)

    def wrap(x):
        return (x + (1 << 31)) % (1 << 32) - (1 << 31)

    for t in range(T):
        for c in range(C):
            g0, g1 = (m[c][0] >> 4) + 1, (m[c][1] >> 4) + 1
            g2 = max((m[c][2] >> 4) + 1, 1)
            q = (t * C + c) % 5
            av = max(g0 + g1, 0) + q * g2 + g2 // 2
            v[t, c] = av if t % 2 else ~av
            oc = 2 + (av - g0 - g1) // g2 if av >= g0 + g1 else \
                (0 if av < g0 else 1)
            a, b, d = m[c]
            a = wrap(a - ((a + 126) >> 7) * 2) if oc == 0 else \
                wrap(a + ((a + 128) >> 7) * 5)
            if oc >= 1:
                b = wrap(b - ((b + 62) >> 6) * 2) if oc == 1 else \
                    wrap(b + ((b + 64) >> 6) * 5)
            if oc >= 2:
                d = wrap(d - ((d + 30) >> 5) * 2) if oc == 2 else \
                    wrap(d + ((d + 32) >> 5) * 5)
            m[c] = [a, b, d]
    return v


def _limits(kind: str, rng):
    """(slow0, acc0, delta0) rows of one hybrid lane of limit kind `kind`."""
    slow = np.zeros(2, np.int64)
    acc = np.full(2, 300 << 16, np.int64)
    delta = rng.integers(-2, 3, 2).astype(np.int64)
    if kind == "zero":
        acc[:] = 0
        delta[:] = 0
    elif kind == "mid":
        slow[:] = rng.integers(0, 3000 << 8, 2)
    elif kind == "high":
        acc[:] = 0x1400 << 16
        slow[:] = (0x1400 + 0x1500) << 8
    elif kind == "negative":
        acc[:] = -(0xA00 << 16)
        delta[:] = 0
    elif kind == "slow_low":
        acc[:] = 0x800 << 16
    elif kind == "balance_hi":
        slow[1] = 5000 << 8
    elif kind == "balance_lo":
        slow[0] = 5000 << 8
    return slow, acc, delta


def encode_edge_lanes(kind: str, lanes: int = 64, seed: int = 0) -> tuple:
    """The staged inputs of one word-coder launch of `kind`
    (ENCODE_EDGE_KINDS), as numpy arrays in the kernel's argument order:
    words: (res_words (W, L) int32, med0 (L, 2, 3) int64, nvals (L,)
    int32); hybrid: (targets (T, L, C) int32, terms, deltas, num_terms,
    med0, slow0, acc0, delta0, nvals, w0a, w0b, h0a, h0b), every lane on
    ENCODE_EDGE_CHAIN. Mono lanes leave channel 1's medians at 0."""
    mono = kind.endswith("_mono")
    C = 1 if mono else 2
    T = ENCODE_EDGE_STEPS
    rng = np.random.default_rng(seed)
    vals = np.zeros((T, lanes, C), np.int64)
    med0 = np.zeros((lanes, 2, 3), np.int64)
    for i in range(lanes):
        vk = ENCODE_VALUE_KINDS[i % len(ENCODE_VALUE_KINDS)]
        med0[i, :C] = _enc_medians(vk, i, rng)[:C]
        vals[:, i] = _ladder(T, C, med0[i]) if vk == "ladder" else \
            _enc_values(vk, i, T, C, rng)
    nvals = np.full(lanes, T * C, np.int32)
    nvals[5::8] = rng.integers(1, T * C, len(nvals[5::8]))
    nvals[:2] = (0, T * C - 1)[:lanes]
    vals = vals.astype(np.int32)
    if kind.startswith("words"):
        return (np.ascontiguousarray(vals.transpose(0, 2, 1).reshape(
            T * C, lanes)), med0, nvals)
    K = len(ENCODE_EDGE_CHAIN)
    terms = np.zeros((lanes, 16), np.int32)
    terms[:, :K] = ENCODE_EDGE_CHAIN
    deltas = np.zeros((lanes, 16), np.int32)
    w0 = np.zeros((2, lanes, 16), np.int64)
    h0 = np.zeros((2, lanes, 16, 8), np.int64)
    chained = np.arange(lanes) % 4 == 3
    deltas[chained, :K] = rng.integers(1, 8, (int(chained.sum()), K))
    w0[:, chained, :K] = rng.integers(-900, 900, (2, int(chained.sum()), K))
    h0[:, chained, :K] = rng.integers(-(1 << 14), 1 << 14,
                                      (2, int(chained.sum()), K, 8))
    slow0 = np.zeros((lanes, 2), np.int64)
    acc0 = np.zeros((lanes, 2), np.int64)
    delta0 = np.zeros((lanes, 2), np.int64)
    for i in range(lanes):
        slow0[i], acc0[i], delta0[i] = _limits(
            ENCODE_LIMIT_KINDS[i % len(ENCODE_LIMIT_KINDS)], rng)
    return (vals, terms, deltas, np.full(lanes, K, np.int32), med0, slow0,
            acc0, delta0, nvals, w0[0], w0[1], h0[0], h0[1])


# The correction scan's edge lanes (`wvc_edge_lanes`): its inputs built
# directly, with no encoder, WVC_EDGE_STEPS steps over rows of
# WVC_EDGE_WORDS random 32-bit words (every eighth row all zeros or all
# ones, so codes sit at both ends of their range). Each word's maxcode has
# a bit length drawn by the lane's kind, i % 4: `all` (0-31), `short`
# (0-6: the lane's reads stay inside its row), `long` (24-31: the lane
# reads past its row's last word's start early, where the reads repeat the
# clamped window) and `mixed` (0-31, one word in eight a negative
# maxcode); within a length a quarter of the maxcodes are at its ends
# (2^(b-1), 2^b - 1). The codes fall on both sides of the minimal-binary
# split `extras` as the stream's bits do; bit length 31 always reads the
# extra bit (C#'s mod-32 shift). Residuals are random int32 of either sign
# (INT32_MIN among them); every eighth lane from 5 on has bases near
# INT32_MAX or INT32_MIN, so base + code passes int32 and wraps.
WVC_EDGE_STEPS = 256
WVC_EDGE_WORDS = 96
WVC_EDGE_KINDS = ("all", "short", "long", "mixed")
_WVC_BITS = {"all": (0, 31), "short": (0, 6), "long": (24, 31),
             "mixed": (0, 31)}


def wvc_edge_lanes(lanes: int = 64, seed: int = 0, mono: bool = False
                   ) -> tuple:
    """The inputs of one correction-scan launch as numpy arrays in its
    argument order: (wvc_words (L, WVC_EDGE_WORDS) int32, maxcode, base,
    residuals (WVC_EDGE_STEPS, L, C) int32)."""
    rng = np.random.default_rng(seed)
    C = 1 if mono else 2
    T, W = WVC_EDGE_STEPS, WVC_EDGE_WORDS
    words = rng.integers(0, 1 << 32, (lanes, W), dtype=np.uint64)
    words[0::8] = 0
    words[4::8] = 0xFFFFFFFF
    maxcode = np.zeros((T, lanes, C), np.int64)
    for i in range(lanes):
        kind = WVC_EDGE_KINDS[i % len(WVC_EDGE_KINDS)]
        lo, hi = _WVC_BITS[kind]
        b = rng.integers(lo, hi + 1, (T, C))
        low = np.where(b > 0, 1 << np.maximum(b - 1, 0), 0)
        top = np.where(b > 0, (1 << b) - 1, 0)
        mc = low + (rng.random((T, C)) * (top - low + 1)).astype(np.int64)
        end = rng.random((T, C))
        mc = np.where(end < 0.125, low, np.where(end < 0.25, top, mc))
        if kind == "mixed":
            neg = rng.random((T, C)) < 0.125
            mc = np.where(neg, rng.integers(_I32_MIN, 0, (T, C)), mc)
        maxcode[:, i] = mc
    base = rng.integers(-(1 << 16), 1 << 16, (T, lanes, C))
    wide = np.arange(lanes) % 8 == 5
    near = rng.integers(0, 1 << 12, (T, int(wide.sum()), C))
    base[:, wide] = np.where(rng.random(near.shape) < 0.5,
                             _I32_MAX - near, _I32_MIN + near)
    residuals = rng.integers(_I32_MIN, _I32_MAX + 1, (T, lanes, C))
    residuals[::17, :, 0] = _I32_MIN
    residuals[::13] = 0
    return (words.astype(np.uint32).view(np.int32),
            maxcode.astype(np.int32), base.astype(np.int32),
            residuals.astype(np.int32))


# The wvx injection's edge lanes (`wvx_edge_lanes`): lane i cycles, each on
# its own period, through
# - sent_bits i % 5: 0, 1-8, 9-31, 32 (mask 0) and 33-255 (shifts mod 32);
# - max_width (i // 5) % 4: 0, 31, 1-31 and 1-6, so that a truncation
#   leaves 0 < btr < sent_bits or btr <= 0 (nothing read);
# - start_bc i % 4: 0, 3, 7-40 and -40..-1;
# - the re-expansion arm (i // 3) % 4: none, zeros, ones, dups, shifts of
#   1-40 (mod 32);
# - values (i // 2) % 4: narrow (0-12 bits), full int32, the extremes
#   (INT32_MIN, -1, 0, 1, INT32_MAX, +/-2^30) and random bit lengths, with
#   INT32_MIN, -1 and INT32_MAX in every lane;
# - nsamples i % 9: 0 (lane 0), T, a random count, else T;
# - rows: i % 6 == 1 starts two words before the row's end, so its cursor
#   runs past the last word into Stream::peek's clamp and the EOF fill
#   (lanes of wide sent_bits run past the row too); rows i % 8 == 3 are
#   zeros and i % 8 == 7 ones;
# - mono: FALSE_STEREO on i % 3 == 2 (the second pass over zeros);
# - outside the kernel's 32-bit range (its int64 body): i % 16 == 11
#   starts within 2^12 bits of 2^31, i % 16 == 13 has sent_bits 256-4000
#   (not a metadata byte, but inside the function's domain).
WVX_EDGE_STEPS = 64
WVX_EDGE_WORDS = 48
WVX_EXTREMES = (_I32_MIN, -1, 0, 1, _I32_MAX, 1 << 30, -(1 << 30))


def _wvx_values(kind: int, T: int, C: int, rng) -> np.ndarray:
    if kind == 0:
        bits = rng.integers(0, 13, (T, C))
        v = rng.integers(0, 1 << 13, (T, C)) & ((1 << bits) - 1)
        v = np.where(rng.random((T, C)) < 0.5, -v - 1, v)
    elif kind == 1:
        v = rng.integers(_I32_MIN, _I32_MAX + 1, (T, C))
    elif kind == 2:
        v = rng.choice(np.asarray(WVX_EXTREMES, np.int64), (T, C))
    else:
        bits = rng.integers(0, 32, (T, C))
        v = rng.integers(0, 1 << 31, (T, C)) >> (31 - bits)
        v = np.where(rng.random((T, C)) < 0.5, ~v, v)
    at = rng.integers(0, T, 3)
    v[at, rng.integers(0, C, 3)] = (_I32_MIN, -1, _I32_MAX)
    return v


def wvx_edge_lanes(lanes: int = 64, seed: int = 0, mono: bool = False,
                   steps: int = WVX_EDGE_STEPS) -> tuple:
    """The inputs of one wvx injection launch as numpy arrays in
    wvx_inject's argument order: (out (steps, L, C) int32, nsamples (L,)
    int32, wvx_words (L, WVX_EDGE_WORDS) int32, wvx_start_bit,
    wvx_start_bc, sent_bits, max_width (L,) int32, int32_zod (L, 3)
    int32, false_stereo (L,) bool, all False in stereo)."""
    rng = np.random.default_rng(seed)
    C = 1 if mono else 2
    T, W = steps, WVX_EDGE_WORDS
    out = np.zeros((T, lanes, C), np.int64)
    ns = np.full(lanes, T, np.int64)
    words = rng.integers(0, 1 << 32, (lanes, W), dtype=np.uint64)
    words[3::8] = 0
    words[7::8] = 0xFFFFFFFF
    start_bit = rng.choice([0, 5], lanes).astype(np.int64)
    start_bc = np.zeros(lanes, np.int64)
    sent = np.zeros(lanes, np.int64)
    mw = np.zeros(lanes, np.int64)
    zod = np.zeros((lanes, 3), np.int64)
    for i in range(lanes):
        out[:, i] = _wvx_values((i // 2) % 4, T, C, rng)
        sent[i] = (0, int(rng.integers(1, 9)), int(rng.integers(9, 32)), 32,
                   int(rng.integers(33, 256)))[i % 5]
        mw[i] = (0, 31, int(rng.integers(1, 32)),
                 int(rng.integers(1, 7)))[(i // 5) % 4]
        start_bc[i] = (0, 3, int(rng.integers(7, 41)),
                       int(rng.integers(-40, 0)))[i % 4]
        arm = (i // 3) % 4
        if arm:
            zod[i, arm - 1] = rng.integers(1, 41)
        if i % 9 == 0:
            ns[i] = 0
        elif i % 9 == 7:
            ns[i] = rng.integers(1, T)
        if i % 6 == 1:
            start_bit[i] = (W - 2) * 32 + rng.integers(0, 41)
        if i % 16 == 11:
            start_bit[i] = (1 << 31) - rng.integers(1, 1 << 12)
        elif i % 16 == 13:
            sent[i] = rng.integers(256, 4001)
    fs = (np.arange(lanes) % 3 == 2) if mono else np.zeros(lanes, bool)
    i32 = [a.astype(np.int32) for a in (start_bit, start_bc, sent, mw, zod)]
    return (out.astype(np.int32), ns.astype(np.int32),
            words.astype(np.uint32).view(np.int32), *i32, fs)
