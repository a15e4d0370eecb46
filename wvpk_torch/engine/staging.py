"""Block staging: group parsed blocks into buckets and build their
(lane, ...) arrays (port of wvpk/engine/staging.py).

Buckets are keyed by the block profile (mono, hybrid, float, int32, wvx,
wvc, sample capacity); everything else (terms, medians, shifts, joint
flag, ...) is per-lane data. The arrays are numpy and are wvpk's Bucket
arrays under the same names, so `bucket_tensors` takes a bucket from
either package. The wvx and wvc streams stage as their own (L, W) word
arrays. As in wvpk, a bucket whose lanes mix term chains is sorted so
that each frequent chain's lanes are contiguous (`_order_by_chain`), and
`chain_segments` names those lane runs; `static_terms` is a uniform
bucket's chain. The decorrelation kernel runs an instantiation compiled
for the chain on each such run (ops/decorr_cuda.py::CHAINS).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import consts, trace
from ..config import get_options
from ..container.blockstate import BlockState
from ..ops.bitio import pack_streams
from ..tables import i32
from .fused import DEVICE_FIELDS, NARROW, TERM_FIELDS, WVC_FIELDS, \
    WVX_FIELDS, build_blob, restore_terms, to_device, unpack_blob


# mixed-chain buckets (wvpk/config.py:47-50, decorr_segment_min and
# decorr_segment_classes): a term chain earns its own decorrelation segment
# when it fills at least _SEGMENT_MIN lanes; at most _SEGMENT_CLASSES chains
# do, the rest share one generic tail segment
_SEGMENT_MIN = 64
_SEGMENT_CLASSES = 8


def _pow2_at_least(n: int, lo: int | None = None) -> int:
    v = lo if lo is not None else get_options().capacity_floor
    while v < n:
        v *= 2
    return v


@dataclass(frozen=True)
class Profile:
    mono: bool
    hybrid: bool
    hybrid_bitrate: bool
    hybrid_balance: bool
    is_float: bool
    is_int32: bool
    has_wvx: bool
    has_wvc: bool
    nsteps: int      # padded word-slot count for the entropy scan
    nsamples_cap: int


def profile_of(st: BlockState) -> Profile:
    f = st.flags
    mono = bool(f & consts.MONO_DATA)
    cap = _pow2_at_least(st.header.block_samples)
    has_wvx = st.wvxbits is not None and not (f & consts.FLOAT_DATA)
    return Profile(
        mono=mono,
        hybrid=bool(f & consts.HYBRID_FLAG),
        hybrid_bitrate=bool(f & consts.HYBRID_BITRATE),
        hybrid_balance=bool(f & consts.HYBRID_BALANCE),
        is_float=bool(f & consts.FLOAT_DATA),
        is_int32=bool(f & consts.INT32_DATA),
        has_wvx=has_wvx,
        has_wvc=(st.wvcbits is not None and st.wvc_crc is not None
                 and not has_wvx
                 and bool(f & consts.HYBRID_FLAG)),
        nsteps=cap * (1 if mono else 2),
        nsamples_cap=cap,
    )


@dataclass
class Bucket:
    profile: Profile
    states: list[BlockState]
    indices: list[int]          # positions in the caller's block list
    words: np.ndarray
    nwords_lane: np.ndarray
    nsamples: np.ndarray
    med: np.ndarray
    slow: np.ndarray
    acc: np.ndarray
    delta: np.ndarray
    terms: np.ndarray
    deltas16: np.ndarray
    wa: np.ndarray
    wb: np.ndarray
    hist_a: np.ndarray
    hist_b: np.ndarray
    num_terms: np.ndarray
    joint: np.ndarray
    mute_limit: np.ndarray
    hdr_crc: np.ndarray
    crc_mvx: np.ndarray
    shift: np.ndarray
    bytes_stored: np.ndarray
    float_shift_eff: np.ndarray
    int32_zod: np.ndarray       # zeros/ones/dups for the int32 expansion
    sent_bits: np.ndarray
    max_width: np.ndarray
    wvx_words: np.ndarray | None = None
    wvx_start_bit: np.ndarray | None = None
    wvx_start_bc: np.ndarray | None = None
    # hybrid-lossless correction streams and the correction blocks'
    # header CRCs, which cover the exact samples
    wvc_words: np.ndarray | None = None
    wvc_crc: np.ndarray | None = None
    # (chain, start, stop, num_terms_max) lane runs of a mixed-chain
    # bucket, chain None for the generic tail; None when the bucket is
    # uniform (static_terms covers it) or no chain fills a segment
    chain_segments: tuple | None = None

    @property
    def static_terms(self) -> tuple | None:
        """The bucket's uniform decorrelation term chain, or None when
        its lanes differ or have no terms."""
        nt = np.asarray(self.num_terms)
        if nt.size == 0 or not (nt == nt[0]).all():
            return None
        n = int(nt[0])
        if n == 0:
            return None
        t = np.asarray(self.terms)[:, :n]
        if not (t == t[0]).all():
            return None
        return tuple(int(x) for x in t[0])


def _fixup_params(st: BlockState) -> tuple[int, tuple[int, int, int]]:
    """Host part of fixup_samples' parameter adjustment
    (UnpackUtils.cs:1316-1345). Returns (shift, (zeros, ones, dups))."""
    f = st.flags
    shift = (f & consts.SHIFT_MASK) >> consts.SHIFT_LSB
    zeros, ones, dups = st.int32_zeros, st.int32_ones, st.int32_dups
    sent = st.int32_sent_bits
    if not (f & consts.INT32_DATA) or (f & consts.FLOAT_DATA):
        return shift, (0, 0, 0)
    if st.wvxbits is not None:
        return shift, (zeros, ones, dups)
    if sent == 0 and (zeros + ones + dups):
        lossy = bool(f & consts.HYBRID_FLAG)
        while lossy and (f & consts.BYTES_STORED) == 3 and shift < 8:
            if zeros > 0:
                zeros -= 1
            elif ones > 0:
                ones -= 1
            elif dups > 0:
                dups -= 1
            else:
                break
            shift += 1
        return shift, (zeros, ones, dups)
    return shift + zeros + sent + ones + dups, (0, 0, 0)


def _mute_limit(st: BlockState) -> int:
    mag = (st.flags & consts.MAG_MASK) >> consts.MAG_LSB
    lim = i32((1 << mag) + 2)
    if st.flags & consts.HYBRID_FLAG:
        lim = i32(lim * 2)
    return lim


def _float_shift(st: BlockState) -> int:
    sh = st.float_max_exp - st.float_norm_exp + st.float_shift
    return max(-32, min(32, sh))


def _chain_of(st: BlockState) -> tuple:
    return tuple(st.terms[:st.num_terms])


def _order_by_chain(states: list[BlockState], indices: list[int],
                    mono: bool):
    """Sort a bucket's lanes so that the lanes of each frequent chain are
    contiguous (wvpk/engine/staging.py::_order_by_chain): chains of at
    least _SEGMENT_MIN lanes, the _SEGMENT_CLASSES most frequent first,
    each get a segment; the other lanes form one generic
    tail segment. Mono chains with cross-channel terms get none. Lane
    order inside a bucket is free: results map back through
    Bucket.states/indices. Returns (states, indices, chain_segments)."""
    first = states[0]
    if all(st.num_terms == first.num_terms and st.terms == first.terms
           for st in states):     # a uniform bucket, without a tuple a lane
        return states, indices, None
    chains = [_chain_of(st) for st in states]
    counts: dict[tuple, int] = {}
    for c in chains:
        counts[c] = counts.get(c, 0) + 1
    if len(counts) == 1:
        return states, indices, None
    specializable = sorted(
        (c for c, n in counts.items()
         if n >= _SEGMENT_MIN and len(c) > 0
         and not (mono and any(t < 0 for t in c))),
        key=lambda c: -counts[c])[:_SEGMENT_CLASSES]
    if not specializable:
        return states, indices, None
    rank = {c: k for k, c in enumerate(specializable)}
    order = sorted(range(len(states)),
                   key=lambda i: rank.get(chains[i], len(rank)))
    states = [states[i] for i in order]
    indices = [indices[i] for i in order]
    segments, pos = [], 0
    for c in specializable:
        segments.append((c, pos, pos + counts[c], len(c)))
        pos += counts[c]
    if pos < len(states):
        tail_ntm = max(len(chains[i]) for i in order[pos:])
        segments.append((None, pos, len(states), max(tail_ntm, 1)))
    return states, indices, tuple(segments)


def stage(states: list[BlockState], indices: list[int]) -> Bucket:
    prof = profile_of(states[0])
    states, indices, chain_segments = _order_by_chain(states, indices,
                                                      prof.mono)
    words, _ = pack_streams([st.wvbits or b"" for st in states])
    chans = 1 if prof.mono else 2
    nsamples = np.asarray([st.header.block_samples for st in states],
                          np.int32)
    fix = [_fixup_params(st) for st in states]
    b = Bucket(
        profile=prof, states=states, indices=indices,
        words=words,
        nwords_lane=nsamples * chans,
        nsamples=nsamples,
        med=np.asarray([st.medians for st in states], np.int64),
        slow=np.asarray([st.slow_level for st in states], np.int64),
        acc=np.asarray([st.bitrate_acc for st in states], np.int64),
        delta=np.asarray([st.bitrate_delta for st in states], np.int64),
        terms=np.asarray([st.terms for st in states], np.int32),
        deltas16=np.asarray([st.deltas for st in states], np.int32),
        wa=np.asarray([st.weights_a for st in states], np.int32),
        wb=np.asarray([st.weights_b for st in states], np.int32),
        hist_a=np.asarray([st.samples_a for st in states], np.int64),
        hist_b=np.asarray([st.samples_b for st in states], np.int64),
        num_terms=np.asarray([st.num_terms for st in states], np.int32),
        joint=np.asarray([bool(st.flags & consts.JOINT_STEREO)
                          for st in states]),
        mute_limit=np.asarray([_mute_limit(st) for st in states], np.int64),
        hdr_crc=np.asarray([st.header.crc for st in states], np.int32),
        crc_mvx=np.asarray([st.crc_mvx for st in states], np.int32),
        shift=np.asarray([s for s, _ in fix], np.int32),
        bytes_stored=np.asarray([st.flags & consts.BYTES_STORED
                                 for st in states], np.int32),
        float_shift_eff=np.asarray([_float_shift(st) for st in states],
                                   np.int32),
        int32_zod=np.asarray([z for _, z in fix], np.int32),
        sent_bits=np.asarray([st.int32_sent_bits for st in states],
                             np.int32),
        max_width=np.asarray([st.int32_max_width for st in states],
                             np.int32),
        chain_segments=chain_segments,
    )
    if prof.has_wvc:
        b.wvc_words, _ = pack_streams([st.wvcbits or b"" for st in states])
        b.wvc_crc = np.asarray(
            [st.wvc_crc if st.wvc_crc is not None else 0 for st in states],
            np.int32)
    if prof.has_wvx:
        b.wvx_words, _ = pack_streams([st.wvxbits or b"" for st in states])
        b.wvx_start_bit = np.asarray([st.wvx_start_bit for st in states],
                                     np.int32)
        # bc after the optional leading getbits(5) reads (new-style field)
        b.wvx_start_bc = np.asarray(
            [3 if st.wvx_start_bit == 5 else 0 for st in states], np.int32)
    return b


def group_blocks(states: list[BlockState]) -> list[Bucket]:
    groups: dict[Profile, tuple[list[BlockState], list[int]]] = {}
    for i, st in enumerate(states):
        key = profile_of(st)
        groups.setdefault(key, ([], []))
        groups[key][0].append(st)
        groups[key][1].append(i)
    return [stage(sts, idxs) for (sts, idxs) in groups.values()]


def bucket_tensors(bucket, device: torch.device) -> dict[str, torch.Tensor]:
    """The bucket's per-lane arrays as tensors on `device`: the state the
    decode carries, with the wvx or wvc streams of such a bucket, and for
    wvx the FALSE_STEREO flag per lane. `bucket` is this module's Bucket
    or wvpk's (same fields). On CUDA the arrays travel as one pinned host
    blob with one non-blocking copy."""
    prof = bucket.profile
    ntm = max(int(np.max(bucket.num_terms)), 1)
    names = DEVICE_FIELDS + (WVX_FIELDS if prof.has_wvx else ()) \
        + (WVC_FIELDS if prof.has_wvc else ())
    arrays = {}
    for name in names:
        a = getattr(bucket, name)
        if name in TERM_FIELDS:
            a = a[:, :ntm]
        arrays[name] = a
    if prof.has_wvx:
        arrays["false_stereo"] = np.asarray(
            [bool(st.flags & consts.FALSE_STEREO) for st in bucket.states])
    blob, metas = build_blob(arrays, NARROW)
    trace.count("h2d_bytes", blob.nbytes)
    return restore_terms(unpack_blob(to_device(blob, device), metas))
