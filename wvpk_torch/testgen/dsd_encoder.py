"""DSD test-vector encoder: raw (mode 0), fast range coder (mode 1) and
high arithmetic coder (mode 3), exact inverses of wvpk.ref.dsd_oracle
(reference DsdUtils.cs:56-493)."""

from __future__ import annotations

import numpy as np

from .. import consts
from ..container.header import HEADER_SIZE
from ..tables import i32, u32
from .encoder import mkmeta

PRECISION = 20
VALUE_ONE = 1 << PRECISION
PRECISION_USE = 12
PTABLE_MASK = 255
UP = 0x010000FE
DOWN = 0x00010000
DECAY = 8


class _RangeEmitter:
    def __init__(self):
        self.low = 0
        self.high = 0xFFFFFFFF
        self.out = bytearray()

    def renorm(self):
        while ((self.high ^ self.low) & 0xFF000000) == 0:
            self.out.append((self.high >> 24) & 0xFF)
            self.high = u32((self.high << 8) | 0xFF)
            self.low = u32(self.low << 8)

    def flush(self):
        # terminate: pick value == low; emit its 4 bytes
        self.high = self.low
        for _ in range(4):
            self.out.append((self.high >> 24) & 0xFF)
            self.high = u32(self.high << 8)


def _encode_fast_stream(codes, probs: np.ndarray,
                        summed: np.ndarray, bins: int, mono: bool) -> bytes:
    from .. import native as _native
    res = _native.dsd_encode_fast_native(
        np.asarray(codes, np.int64), probs, summed, bins, mono)
    if res is not None:
        return res
    return _encode_fast_stream_py(list(codes), probs, summed, bins, mono)


def _encode_fast_stream_py(codes: list[int], probs: np.ndarray,
                           summed: np.ndarray, bins: int,
                           mono: bool) -> bytes:
    em = _RangeEmitter()
    p0 = p1 = 0
    for code in codes:
        total = int(summed[p0, 255])
        mult = u32(em.high - em.low) // total
        if mult == 0:
            # interval exhausted: decoder reads 4 fresh bytes
            # (DsdUtils.cs:263-274); emit the current position and reset
            em.high = em.low
            for _ in range(4):
                em.out.append((em.high >> 24) & 0xFF)
                em.high = u32(em.high << 8)
            em.low, em.high = 0, 0xFFFFFFFF
            mult = em.high // total
        if code > 0:
            em.low = u32(em.low + int(summed[p0, code - 1]) * mult)
        em.high = u32(em.low + int(probs[p0, code]) * mult - 1)
        if mono:
            p0 = code & (bins - 1)
        else:
            p0, p1 = p1, code & (bins - 1)
        em.renorm()
    em.flush()
    return bytes(em.out)


def _build_fast_tables(data: np.ndarray, bins: int, mono: bool):
    """Histogram per history bin, scaled to byte probabilities.

    The history-bin chain unrolls in closed form: the bin used at step i
    is data[i-1] & mask (mono) or data[i-2] & mask (stereo: p0/p1 swap
    per step), with bin 0 for the first one/two steps — so the
    histogram is one vectorized np.add.at instead of a per-value loop."""
    lag = 1 if mono else 2
    bin_idx = np.zeros(data.size, np.int64)
    if data.size > lag:
        bin_idx[lag:] = data[:-lag] & (bins - 1)
    probs = np.zeros((bins, 256), np.int64)
    np.add.at(probs, (bin_idx, data), 1)
    out = np.zeros((bins, 256), np.uint8)
    for bi in range(bins):
        total = probs[bi].sum()
        if total == 0:
            continue
        hi = probs[bi].max()
        scale = max(1, (hi + 99) // 100)  # cap max prob at ~100
        row = np.where(probs[bi] > 0, np.maximum(probs[bi] // scale, 1), 0)
        while row.sum() > 1280:  # MAX_BYTES_PER_BIN
            row = np.where(row > 1, row // 2, row)
        out[bi] = row
    return out


def _rle_table(probs: np.ndarray, max_probability: int = 0xA0) -> bytes:
    out = bytearray([max_probability])
    flat = probs.reshape(-1)
    i = 0
    n = flat.size
    while i < n:
        if flat[i] == 0:
            z = 0
            while i < n and flat[i] == 0 and z < (255 - max_probability):
                z += 1
                i += 1
            out.append(max_probability + z)
        else:
            assert flat[i] <= max_probability
            out.append(int(flat[i]))
            i += 1
    out.append(0)  # terminator consumed by the reader
    return bytes(out)


def _encode_high_stream(data: np.ndarray, filters_init: np.ndarray,
                        ptable: np.ndarray, mono: bool) -> bytes:
    from .. import native as _native
    nch = 1 if mono else 2
    res = _native.dsd_encode_high_native(
        np.asarray(data, np.int64), filters_init[:nch], ptable, nch)
    if res is not None:
        return res
    return _encode_high_stream_py(data, filters_init, ptable, mono)


def _encode_high_stream_py(data: np.ndarray, filters_init: np.ndarray,
                           ptable: np.ndarray, mono: bool) -> bytes:
    em = _RangeEmitter()
    pt = [int(x) for x in ptable]
    nch = 1 if mono else 2
    f = [{"value": 0, "f0": 0,
          "f1": int(filters_init[ch, 0]), "f2": int(filters_init[ch, 1]),
          "f3": int(filters_init[ch, 2]), "f4": int(filters_init[ch, 3]),
          "f5": int(filters_init[ch, 4]), "f6": 0,
          "factor": int(filters_init[ch, 6])} for ch in range(nch)]
    n = data.shape[0] // nch
    for t in range(n):
        for sp in f:
            sp["value"] = i32(sp["f1"] - sp["f5"] + (i32(sp["f6"] * sp["factor"]) >> 2))
        for bit_i in range(8):
            for ch, sp in enumerate(f):
                byte = int(data[t * nch + ch])
                b = (byte >> (7 - bit_i)) & 1
                pp = (sp["value"] >> (PRECISION - PRECISION_USE)) & PTABLE_MASK
                split = u32(em.low + (u32(em.high - em.low) >> 8) * (u32(pt[pp]) >> 16))
                if b:
                    em.high = split
                    pt[pp] = i32(pt[pp] + ((UP - pt[pp]) >> DECAY))
                    sp["f0"] = -1
                else:
                    em.low = u32(split + 1)
                    pt[pp] = i32(pt[pp] + ((DOWN - pt[pp]) >> DECAY))
                    sp["f0"] = 0
                em.renorm()
                sp["value"] = i32(sp["value"] + i32(sp["f6"] * 8))
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
            sp["factor"] = i32(sp["factor"] - ((sp["factor"] + 512) >> 10))
    em.flush()
    return bytes(em.out)


def encode_dsd_file(data: np.ndarray, mode: int, mono: bool = False,
                    mult_log: int = 3, sample_rate: int = 44100,
                    history_bits: int = 1, block_samples: int | None = None,
                    block_checksum: int = 0) -> bytes:
    """Encode DSD byte data (n, ch) into a .wv file; mode in {0, 1, 3}.

    block_checksum (0/2/4) appends a trailing ID_BLOCK_CHECKSUM item per
    block (extension; see container/checksum.py)."""
    if data.ndim == 1:
        data = data[:, None]
    nch = data.shape[1]
    assert nch == (1 if mono else 2)
    n = data.shape[0]
    if block_samples is None:
        block_samples = n
    out = bytearray()
    for start in range(0, n, block_samples):
        end = min(start + block_samples, n)
        blk = _encode_dsd_block(data[start:end], mode, mono, mult_log,
                                sample_rate, history_bits,
                                block_index=start, total_samples=n)
        if block_checksum:
            from ..container.checksum import add_block_checksum
            blk = add_block_checksum(blk, block_checksum)
        out += blk
    return bytes(out)


def _encode_dsd_block(data: np.ndarray, mode: int, mono: bool, mult_log: int,
                      sample_rate: int, history_bits: int,
                      block_index: int, total_samples: int) -> bytes:
    n, nch = data.shape
    interleaved = data.reshape(-1).astype(np.int64)
    payload = bytearray([mult_log, mode])
    if mode == 0:
        payload += bytes(int(x) & 0xFF for x in interleaved)
    elif mode == 1:
        bins = 1 << history_bits
        probs = _build_fast_tables(interleaved, bins, mono)
        summed = np.cumsum(probs.astype(np.int64), axis=1)
        payload.append(history_bits)
        payload += _rle_table(probs)
        payload += _encode_fast_stream(interleaved.tolist(), probs, summed,
                                       bins, mono)
    elif mode == 3:
        rate_i, rate_s = 10, 20
        from ..container.blockstate import _init_ptable
        ptable = _init_ptable(rate_i, rate_s)
        filters_init = np.zeros((2, 8), np.int64)
        fbytes = bytearray([rate_i, rate_s])
        for ch in range(nch):
            raw = [0x80, 0x80, 0x80, 0x80, 0x80]
            for k, r in enumerate(raw):
                filters_init[ch, k] = r << (PRECISION - 8)
            factor = 0
            fbytes += bytes(raw)
            fbytes += factor.to_bytes(2, "little")
            filters_init[ch, 6] = factor
        payload += bytes(fbytes)
        payload += _encode_high_stream(interleaved, filters_init, ptable, mono)
    else:
        raise ValueError(mode)

    flags = consts.DSD_FLAG | consts.INITIAL_BLOCK | consts.FINAL_BLOCK
    if mono:
        flags |= consts.MONO_FLAG
    try:
        srate_idx = consts.SAMPLE_RATES.index(sample_rate)
    except ValueError:
        srate_idx = 0xF
    flags |= srate_idx << consts.SRATE_LSB

    body = mkmeta(consts.ID_DSD_BLOCK, bytes(payload))
    ck_size = HEADER_SIZE + len(body) - 8
    header = bytearray(HEADER_SIZE)
    header[0:4] = b"wvpk"
    header[4:8] = ck_size.to_bytes(4, "little")
    header[8:10] = (0x410).to_bytes(2, "little")
    header[11] = (total_samples >> 32) & 0xFF
    header[12:16] = (total_samples & 0xFFFFFFFF).to_bytes(4, "little")
    header[10] = (block_index >> 32) & 0xFF
    header[16:20] = (block_index & 0xFFFFFFFF).to_bytes(4, "little")
    header[20:24] = n.to_bytes(4, "little")
    header[24:28] = flags.to_bytes(4, "little")
    block = bytes(header) + body

    # stamp crc in closed form: decode output == source bytes for every
    # mode (roundtrip identity is asserted in tests), and the DSD CRC
    # crc = crc*3 + b from -1 (DsdUtils.cs:73-101) is the same affine
    # recurrence _crc_fast evaluates — no per-block oracle decode needed
    # (WVPK_DSD_ORACLE_STAMP=1 restores the decode-and-stamp path as a
    # differential check)
    import os
    blk = bytearray(block)
    if os.environ.get("WVPK_DSD_ORACLE_STAMP"):
        from ..container import (decode_block_state, iter_metadata,
                                 read_next_header)
        from ..ref.dsd_oracle import unpack_dsd_samples
        hdr = read_next_header(block, 0)
        st, _ = decode_block_state(hdr, iter_metadata(block, hdr))
        crc = unpack_dsd_samples(st).crc
    else:
        from .encoder import _crc_fast
        crc = _crc_fast(interleaved & 0xFF)
    blk[28:32] = (crc & 0xFFFFFFFF).to_bytes(4, "little")
    return bytes(blk)
