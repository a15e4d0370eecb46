"""Edge streams: for the entropy decoder, one bucket of one profile whose
lanes take every path of get_words (WordsUtils.cs:272-511); for the DSD
decoders, one group of one profile whose lanes take every branch of the
mode-1 and mode-3 coders (`dsd_edge_states`, at the end).

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


def edge_states(profile: str, lanes: int = 64, seed: int = 0) -> list:
    """Block states of `lanes` one-block files of `profile`
    (EDGE_PROFILES), lane i of kind EDGE_KINDS[i % 6]; their payloads
    damaged as the kind says, the .wvc of a wvc profile paired."""
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
