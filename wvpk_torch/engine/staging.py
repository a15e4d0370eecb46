"""Block staging: group parsed blocks into buckets and build their
(lane, ...) arrays (port of wvpk/engine/staging.py).

Buckets are keyed by the block profile (mono, sample capacity, ...);
everything else (terms, medians, shifts, joint flag, ...) is per-lane data.
The arrays are numpy and are wvpk's Bucket arrays under the same names,
so `bucket_tensors` takes a bucket from either package. Not carried over:
the TPU compile specialisations (lane order by term chain,
`chain_segments`, `static_terms`) and the wvx and wvc streams, which wait
for their slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from wvpk import consts
from wvpk.config import get_options
from wvpk.container.blockstate import BlockState
from wvpk.tables import i32

from ..ops.bitio import pack_streams
from .fused import DEVICE_FIELDS, NARROW, TERM_FIELDS, build_blob, \
    restore_terms, unpack_blob


def check_slice(st: BlockState) -> None:
    """Raise NotImplementedError for a block outside the port's slice
    (lossless integer PCM), naming the ROADMAP slice that adds it."""
    f = st.flags
    if f & consts.DSD_FLAG:
        what, item = "DSD", "DSD slice (queue 1, item 10)"
    elif f & consts.HYBRID_FLAG:
        what, item = "hybrid", "hybrid slice (queue 1, item 8)"
    elif f & consts.FLOAT_DATA:
        what, item = "float", "hybrid + float slice (queue 1, item 8)"
    elif st.wvxbits is not None:
        what, item = "int32+wvx", "hybrid + int32/wvx slice (queue 1, item 8)"
    else:
        return
    raise NotImplementedError(
        f"wvpk_torch decodes lossless integer PCM only: {what} blocks "
        f"wait for the ROADMAP {item}")


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


def stage(states: list[BlockState], indices: list[int]) -> Bucket:
    prof = profile_of(states[0])
    words, _ = pack_streams([st.wvbits or b"" for st in states])
    chans = 1 if prof.mono else 2
    nsamples = np.asarray([st.header.block_samples for st in states],
                          np.int32)
    fix = [_fixup_params(st) for st in states]
    return Bucket(
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
    )


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
    decode carries. `bucket` is this module's Bucket or wvpk's (same
    fields). On CUDA the arrays travel as one pinned host blob with one
    non-blocking copy."""
    ntm = max(int(np.max(bucket.num_terms)), 1)
    arrays = {}
    for name in DEVICE_FIELDS:
        a = getattr(bucket, name)
        if name in TERM_FIELDS:
            a = a[:, :ntm]
        arrays[name] = a
    blob, metas = build_blob(arrays, NARROW)
    host = torch.from_numpy(blob)
    if device.type == "cuda":
        host = host.pin_memory()
    dev_blob = host.to(device, non_blocking=True)
    return restore_terms(unpack_blob(dev_blob, metas))
