"""Scalar oracle for DSD block decode (reference DsdUtils.cs:56-493).

Mode 0: raw bytes + CRC. Mode 1 ("fast"): byte-wise range decoder over
per-history-bin probability tables. Mode 3 ("high"): binary arithmetic coder
with adaptive ptable and a 6-stage leaky-integrator filter bank per channel.
All arithmetic mirrors C# int/uint wrap semantics.
"""

from __future__ import annotations

import numpy as np

from .. import consts
from ..container.blockstate import BlockState
from ..tables import i32, u32

MAX_DSD_BITS_VALUE = 256
PTABLE_MASK = 255
UP = 0x010000FE
DOWN = 0x00010000
DECAY = 8
PRECISION = 20
VALUE_ONE = 1 << PRECISION
PRECISION_USE = 12


def _decode_fast(st: BlockState, out: list[int], sample_count: int) -> bool:
    d = st.dsd
    data = d.data
    nbytes = len(data)
    byteptr = 0
    value, low, high = d.value, d.low, d.high
    p0 = p1 = 0
    summed = d.summed_probabilities
    probs = d.probabilities
    lookup = d.lookup_buffer
    vlook = d.value_lookup
    bins = d.history_bins
    crc = st._crc  # running block crc, managed by caller
    mono = bool(st.flags & consts.MONO_DATA)
    total = sample_count if mono else sample_count * 2
    optr = 0
    for _ in range(total):
        sp255 = int(summed[p0, 255])
        if sp255 == 0:
            return False
        mult = u32(high - low) // sp255
        if mult == 0:
            if nbytes - byteptr >= 4:
                for _ in range(4):
                    value = u32((value << 8) | data[byteptr])
                    byteptr += 1
            low, high = 0, 0xFFFFFFFF
            mult = high // sp255
            if mult == 0:
                return False
        index = u32(value - low) // mult
        if index >= sp255:
            return False
        code = int(lookup[int(vlook[p0]) + index])
        out[optr] = code
        optr += 1
        if code > 0:
            low = u32(low + int(summed[p0, code - 1]) * mult)
        high = u32(low + int(probs[p0, code]) * mult - 1)
        crc = i32(crc * 3 + code)
        if mono:
            p0 = code & (bins - 1)
        else:
            p0, p1 = p1, code & (bins - 1)
        while ((high ^ low) & 0xFF000000) == 0 and byteptr < nbytes:
            value = u32((value << 8) | data[byteptr])
            byteptr += 1
            high = u32((high << 8) | 0xFF)
            low = u32(low << 8)
    st._crc = crc
    return True


def _decode_high(st: BlockState, out: list[int], sample_count: int) -> bool:
    d = st.dsd
    data = d.data
    nbytes = len(data)
    byteptr = 0
    value, low, high = d.value, d.low, d.high
    ptable = [int(x) for x in d.ptable]
    stereo = not (st.flags & consts.MONO_DATA)
    nch = 2 if stereo else 1
    # per-channel filter state: value, filter0..filter6, factor, bytei
    f = [{"value": 0, "f0": 0,
          "f1": int(d.filters[ch, 0]), "f2": int(d.filters[ch, 1]),
          "f3": int(d.filters[ch, 2]), "f4": int(d.filters[ch, 3]),
          "f5": int(d.filters[ch, 4]), "f6": int(d.filters[ch, 5]),
          "factor": int(d.filters[ch, 6]), "bytei": 0}
         for ch in range(nch)]
    crc = st._crc
    optr = 0

    for _ in range(sample_count):
        for sp in f:
            sp["value"] = i32(sp["f1"] - sp["f5"] + (i32(sp["f6"] * sp["factor"]) >> 2))
        for _bit in range(8):
            for sp in f:
                pp = (sp["value"] >> (PRECISION - PRECISION_USE)) & PTABLE_MASK
                split = u32(low + (u32(high - low) >> 8) * (u32(ptable[pp]) >> 16))
                if value <= split:
                    high = split
                    ptable[pp] = i32(ptable[pp] + ((UP - ptable[pp]) >> DECAY))
                    sp["f0"] = -1
                else:
                    low = u32(split + 1)
                    ptable[pp] = i32(ptable[pp] + ((DOWN - ptable[pp]) >> DECAY))
                    sp["f0"] = 0
                while ((high ^ low) & 0xFF000000) == 0 and byteptr < nbytes:
                    value = u32((value << 8) | data[byteptr])
                    byteptr += 1
                    high = u32((high << 8) | 0xFF)
                    low = u32(low << 8)
                sp["value"] = i32(sp["value"] + i32(sp["f6"] * 8))
                sp["bytei"] = i32((sp["bytei"] << 1) | (sp["f0"] & 1))
                v = sp["value"]
                sp["factor"] = i32(sp["factor"] +
                                   ((((v ^ sp["f0"]) >> 31) | 1)
                                    & ((v ^ i32(v - i32(sp["f6"] * 16))) >> 31)))
                sp["f1"] = i32(sp["f1"] + (((sp["f0"] & VALUE_ONE) - sp["f1"]) >> 6))
                sp["f2"] = i32(sp["f2"] + (((sp["f0"] & VALUE_ONE) - sp["f2"]) >> 4))
                sp["f3"] = i32(sp["f3"] + ((sp["f2"] - sp["f3"]) >> 4))
                sp["f4"] = i32(sp["f4"] + ((sp["f3"] - sp["f4"]) >> 4))
                sp["value"] = (sp["f4"] - sp["f5"]) >> 4
                sp["f5"] = i32(sp["f5"] + sp["value"])
                sp["f6"] = i32(sp["f6"] + ((sp["value"] - sp["f6"]) >> 3))
                sp["value"] = i32(sp["f1"] - sp["f5"] + (i32(sp["f6"] * sp["factor"]) >> 2))
        for sp in f:
            code = sp["bytei"] & 0xFF
            out[optr] = code
            optr += 1
            crc = i32(crc * 3 + code)
            sp["factor"] = i32(sp["factor"] - ((sp["factor"] + 512) >> 10))
    st._crc = crc
    return True


def unpack_dsd_samples(st: BlockState):
    """Whole-block DSD decode (reference DsdUtils.cs:56-136)."""
    from .oracle import BlockResult

    flags = st.flags
    hdr = st.header
    sample_count = hdr.block_samples
    mono = bool(flags & consts.MONO_DATA)
    nvals = sample_count if mono else sample_count * 2
    out = [0] * nvals
    st._crc = -1
    mute_error = False
    d = st.dsd

    if d.mode == 0:
        total = nvals
        if len(d.data) < total:
            total = len(d.data)
        crc = -1
        for k in range(total):
            b = d.data[k]
            out[k] = b
            crc = i32(crc * 3 + b)
        st._crc = crc
    elif d.mode == 1:
        if not _decode_fast(st, out, sample_count):
            mute_error = True
    elif d.mode == 3:
        if not _decode_high(st, out, sample_count):
            mute_error = True
    else:
        mute_error = True

    if not mute_error and st._crc != hdr.crc:
        mute_error = True

    if mute_error:
        out = [0x55] * nvals

    if flags & consts.FALSE_STEREO:
        arr = np.zeros((sample_count, 2), np.int32)
        vals = np.asarray(out[:sample_count], np.int64).astype(np.int32)
        arr[:, 0] = vals
        arr[:, 1] = vals
    elif flags & consts.MONO_FLAG:
        arr = np.asarray(out, np.int64).astype(np.int32).reshape(-1, 1)
    else:
        arr = np.asarray(out, np.int64).astype(np.int32).reshape(-1, 2)

    crc_val = st._crc
    del st._crc
    return BlockResult(arr, crc_val, -1, mute_error, mute_error)
