"""DSD decode on tensors (port of wvpk/ops/dsd.py): the coders with
wvpk's contracts, their plain versions of the CUDA kernels in
csrc/dsd_fast.cu and csrc/dsd_high.cu (`*_bytes`: the same decode, the
byte-values delivered as each lane's uint8 row, as the kernels write
them), and the mode-0 CRC.

Mode 0 (raw): byte copy + CRC (DsdUtils.cs:73-82), here a closed form in
tensor ops on either device.
Mode 1 (fast): byte-wise range decoder over per-history-bin cumulative
probability tables (DsdUtils.cs:244-304), one step per output byte.
Mode 3 (high): binary arithmetic coder with an adaptive 256-entry ptable
and a 6-stage leaky-integrator filter bank per channel
(DsdUtils.cs:391-493), one step per output sample (8 bits x channels).

Each coder is a loop over steps, vectorised over lanes (one lane = one
block). C#'s uint32 arithmetic is held in int64 and masked. Two points
where this differs from the XLA functions in form, not in result: mode 1
finds each code by a rank search on the bin's cumulative `summed` row
(code = #{c : summed[c] <= index}), as the Pallas kernel does, so neither
`probs` nor the `lookup`/`vlook` expansion tables are staged; mode 3
updates its ptable by a scatter in place, and both loops stop at the
longest lane's output count (outputs past a lane's count are 0 either
way). Renormalisation is the closed form of the reference's byte loop
(`while ((high ^ low) & 0xFF000000) == 0`): it runs clz(high ^ low) >> 3
times, at most the bytes left.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

I64 = torch.int64
M32 = 0xFFFFFFFF

PTABLE_MASK = 255
UP = 0x010000FE
DOWN = 0x00010000
DECAY = 8
PRECISION = 20
VALUE_ONE = 1 << PRECISION
PRECISION_USE = 12
# the raw CRC's int64 sum holds at most this many products b * 3^k (each
# below 2^40) before it is reduced mod 2^32
_CRC_CHUNK = 1 << 23


def _wrap32s(x):
    """int64 -> the int32 it wraps to (C#'s int overflow), as int64."""
    return x.to(torch.int32).to(I64)


@functools.lru_cache(maxsize=8)
def _pow3(n: int, device: torch.device) -> torch.Tensor:
    """3^k mod 2^32 for k = 0..n, int64, on `device`."""
    p = np.ones(n + 1, np.uint64)
    for k in range(1, n + 1):
        p[k] = (int(p[k - 1]) * 3) & M32
    return torch.from_numpy(p.astype(np.int64)).to(device)


def dsd_raw_crc(data, nvalid):
    """Mode 0: the CRC of each lane's first `nvalid` bytes (init -1,
    crc' = 3 * crc + b, uint32 wrap). data (L, N) bytes (any integer
    dtype); nvalid (L,). Returns crc (L,) int32.

    Closed form: crc = sum_k b_k * 3^(n-1-k) - 3^n mod 2^32, with the
    powers from a table. Tensor ops on either device."""
    L, N = data.shape
    dev = data.device
    pow3 = _pow3(N, dev)
    n = nvalid.to(I64).clamp(0, N)
    total = torch.zeros(L, dtype=I64, device=dev)
    for c0 in range(0, N, _CRC_CHUNK):
        k = torch.arange(c0, min(N, c0 + _CRC_CHUNK), device=dev)[None, :]
        e = n[:, None] - 1 - k
        w = torch.where(e >= 0, pow3[e.clamp(min=0)], 0)
        part = (data[:, c0:c0 + k.shape[1]].to(I64) * w).sum(1)
        total = (total + part) & M32
    return _wrap32s(total - pow3[n]).to(torch.int32)


def _windows(data):
    """(L, NB) int64: entry i of a lane is its bytes i..i+3 as one
    big-endian uint32 (zeros past the row). The coders read their next 4
    bytes with one gather."""
    b = torch.nn.functional.pad(data.to(I64), (0, 3))
    n = data.shape[1]
    return (b[:, :n] << 24) | (b[:, 1:n + 1] << 16) | (b[:, 2:n + 2] << 8) \
        | b[:, 3:n + 3]


def _bytes_be(win, pos):
    """The 4 bytes at `pos` of each lane, big-endian (`win` from
    _windows; pos clamped into the row)."""
    return win.gather(1, pos.clamp(max=win.shape[1] - 1)[:, None])[:, 0]


@functools.lru_cache(maxsize=8)
def _renorm_tables(device: torch.device):
    """The bounds of 1, 2, 3 and 4 leading zero bytes, and the low-bit
    masks (1 << 8k) - 1 for k = 0..4, on `device`."""
    bounds = torch.tensor([1, 1 << 8, 1 << 16, 1 << 24], dtype=I64,
                          device=device)
    masks = torch.tensor([(1 << (8 * k)) - 1 for k in range(5)], dtype=I64,
                         device=device)
    return bounds, masks


def _renorm(high, low, value, bptr, win, nbytes):
    """Closed-form byte renormalisation (DsdUtils.cs:295-300)."""
    bounds, masks = _renorm_tables(high.device)
    k = 4 - torch.bucketize(high ^ low, bounds, right=True)
    k = torch.minimum(k, (nbytes - bptr).clamp(0, 4))
    sh = 8 * k
    w4 = _bytes_be(win, bptr)
    value = ((value << sh) | (w4 >> (32 - sh))) & M32
    high = ((high << sh) | masks[k]) & M32
    low = (low << sh) & M32
    return high, low, value, bptr + k


def dsd_fast_decode(data, nbytes, summed, value0, nvals, *, bins: int,
                    mono: bool, nsteps: int):
    """Mode 1 range decoder.

    data (L, NB) uint8 coded bytes (after the host's table init); nbytes
    (L,); summed (L, bins * 256) int32 cumulative probabilities; value0
    (L,) int64, the initial 32-bit window; nvals (L,) output byte count
    (samples x channels). Returns (out (nsteps, L) int32, err (L,) bool,
    crc (L,) int32). A lane that meets an invalid table, a zero interval
    or an index past its table stops with err set; its later outputs
    are 0."""
    L = data.shape[0]
    dev = data.device
    win = _windows(data)
    lanes = torch.arange(L, device=dev)
    tab = summed.to(I64).reshape(L, bins, 256)
    nbytes = nbytes.to(I64)
    nvals = nvals.to(I64)
    value = value0.to(I64) & M32
    low = torch.zeros(L, dtype=I64, device=dev)
    high = torch.full((L,), M32, dtype=I64, device=dev)
    p0 = torch.zeros(L, dtype=I64, device=dev)
    p1 = torch.zeros(L, dtype=I64, device=dev)
    bptr = torch.zeros(L, dtype=I64, device=dev)
    crc = torch.full((L,), -1, dtype=I64, device=dev)
    err = torch.zeros(L, dtype=torch.bool, device=dev)
    out = torch.zeros((nsteps, L), dtype=torch.int32, device=dev)
    last = min(nsteps, int(nvals.max()) if L else 0)
    for t in range(last):
        active = (nvals > t) & ~err
        row = tab[lanes, p0]                       # (L, 256)
        sp255 = row[:, 255]
        bad0 = sp255 == 0
        sp255s = sp255.clamp(min=1)
        mult = ((high - low) & M32) // sp255s
        # mult == 0: pull 4 fresh bytes (if 4 remain) and reset
        need4 = active & (mult == 0)
        take4 = need4 & ((nbytes - bptr) >= 4)
        v = torch.where(take4, _bytes_be(win, bptr), value)
        bp = torch.where(take4, bptr + 4, bptr)
        lo = torch.where(need4, 0, low)
        hi = torch.where(need4, M32, high)
        mult = torch.where(need4, M32 // sp255s, mult)
        bad_m = mult == 0
        index = ((v - lo) & M32) // mult.clamp(min=1)
        bad_i = index >= sp255
        idx = torch.minimum(index, sp255s - 1)
        code = torch.searchsorted(row, idx[:, None], right=True)[:, 0] \
            .clamp(max=255)
        top = row.gather(1, code[:, None])[:, 0]
        base = torch.where(code > 0,
                           row.gather(1, (code - 1).clamp(min=0)[:, None])
                           [:, 0], 0)
        lo = (lo + base * mult) & M32
        hi = (lo + (top - base) * mult - 1) & M32
        hi, lo, v, bp = _renorm(hi, lo, v, bp, win, nbytes)
        err = err | (active & (bad0 | bad_m | bad_i))
        upd = active & ~err
        hist = code & (bins - 1)
        out[t] = torch.where(upd, code, 0).to(torch.int32)
        value = torch.where(upd, v, value)
        low = torch.where(upd, lo, low)
        high = torch.where(upd, hi, high)
        bptr = torch.where(upd, bp, bptr)
        crc = torch.where(upd, _wrap32s(crc * 3 + code), crc)
        if mono:
            p0 = torch.where(upd, hist, p0)
        else:
            p0, p1 = torch.where(upd, p1, p0), torch.where(upd, hist, p1)
    return out, err, crc.to(torch.int32)


def dsd_high_decode(data, nbytes, ptable0, filters0, value0, nsamples, *,
                    mono: bool, nsteps: int):
    """Mode 3 arithmetic decoder + filter bank.

    data (L, NB) uint8; nbytes (L,); ptable0 (L, 256) int32; filters0
    (L, 2, 8) int32 (f1..f5, f6, factor per channel); value0 (L,) int64;
    nsamples (L,). Returns (out (nsteps, L, C) int32, crc (L,) int32);
    outputs and CRC cover each lane's first `nsamples` steps."""
    L = data.shape[0]
    C = 1 if mono else 2
    dev = data.device
    win = _windows(data)
    nbytes = nbytes.to(I64)
    nsamples = nsamples.to(I64)
    value = value0.to(I64) & M32
    low = torch.zeros(L, dtype=I64, device=dev)
    high = torch.full((L,), M32, dtype=I64, device=dev)
    bptr = torch.zeros(L, dtype=I64, device=dev)
    ptable = ptable0.to(I64).clone()
    # the filter bank, (L, C) each: f1..f6 and factor per channel
    f1, f2, f3, f4, f5, f6, factor = (
        filters0[:, :C, r].to(I64).clone() for r in range(7))
    crc = torch.full((L,), -1, dtype=I64, device=dev)
    out = torch.zeros((nsteps, L, C), dtype=torch.int32, device=dev)
    last = min(nsteps, int(nsamples.max()) if L else 0)
    for t in range(last):
        active = nsamples > t
        # per-sample predictor seed (DsdUtils.cs:401-404)
        val = _wrap32s(f1 - f5 + (_wrap32s(f6 * factor) >> 2))
        bytei = torch.zeros((L, C), dtype=I64, device=dev)
        for _bit in range(8):
            # the coder decodes the channels' bits in turn (they share
            # the ptable and the interval); each channel's filters then
            # update from its own bit alone, so all channels update at
            # once
            bits = []
            for c in range(C):
                pp = (val[:, c] >> (PRECISION - PRECISION_USE)) \
                    & PTABLE_MASK
                pt = ptable.gather(1, pp[:, None])[:, 0]
                # the entry's upper 16 bits as a uint32 (C#'s uint)
                split = (low + (((high - low) & M32) >> 8)
                         * ((pt & M32) >> 16)) \
                    & M32
                bit1 = value <= split
                high = torch.where(bit1, split, high)
                # a 0 bit means value > split, so split + 1 <= 2^32 - 1
                low = torch.where(bit1, low, split + 1)
                # a move toward UP or DOWN: stays in int32, needs no wrap
                pt = pt + ((torch.where(bit1, UP, DOWN) - pt) >> DECAY)
                ptable.scatter_(1, pp[:, None], pt[:, None])
                high, low, value, bptr = _renorm(high, low, value, bptr,
                                                 win, nbytes)
                bits.append(bit1)
            b = torch.stack(bits, 1).to(I64)
            f0 = -b
            v = _wrap32s(val + _wrap32s(f6 * 8))
            bytei = (bytei << 1) | b
            factor = _wrap32s(factor + ((((v ^ f0) >> 31) | 1) & (
                (v ^ _wrap32s(v - _wrap32s(f6 * 16))) >> 31)))
            # each of f1..f6 moves toward a target inside int32 (a shift
            # of the difference never overshoots), so the XLA version's
            # wraps of them are no-ops and are left out
            tgt = f0 & VALUE_ONE
            f1 = f1 + ((tgt - f1) >> 6)
            f2 = f2 + ((tgt - f2) >> 4)
            f3 = f3 + ((f2 - f3) >> 4)
            f4 = f4 + ((f3 - f4) >> 4)
            d = (f4 - f5) >> 4
            f5 = f5 + d
            f6 = f6 + ((d - f6) >> 3)
            val = _wrap32s(f1 - f5 + (_wrap32s(f6 * factor) >> 2))
        code = bytei & 0xFF
        # the CRC takes the channels in order: crc' = 3 * crc + code
        step = crc * 3 + code[:, 0] if C == 1 else \
            crc * 9 + code[:, 0] * 3 + code[:, 1]
        crc = torch.where(active, _wrap32s(step), crc)
        factor = factor - ((factor + 512) >> 10)
        out[t] = torch.where(active[:, None], code, 0).to(torch.int32)
    return out, crc.to(torch.int32)


def _lane_bytes(out):
    """(nsteps, L[, C]) int32 byte-values -> (L, nsteps * C) uint8: each
    lane's values in its memory order (mode 1: the interleaved values;
    mode 3: (sample, channel)), the rows the kernels write."""
    T, L = out.shape[:2]
    return out.reshape(T, L, -1).transpose(0, 1).reshape(L, -1) \
        .to(torch.uint8).contiguous()


def dsd_fast_decode_bytes(data, nbytes, summed, value0, nvals, *,
                          bins: int, mono: bool, nsteps: int):
    """dsd_fast_decode with the codes as (L, nsteps) uint8: returns
    (out, err (L,) bool, crc (L,) int32). The plain version of
    csrc/dsd_fast.cu."""
    out, err, crc = dsd_fast_decode(data, nbytes, summed, value0, nvals,
                                    bins=bins, mono=mono, nsteps=nsteps)
    return _lane_bytes(out), err, crc


def dsd_high_decode_bytes(data, nbytes, ptable0, filters0, value0,
                          nsamples, *, mono: bool, nsteps: int):
    """dsd_high_decode with the codes as (L, nsteps * C) uint8: returns
    (out, crc (L,) int32). The plain version of csrc/dsd_high.cu."""
    out, crc = dsd_high_decode(data, nbytes, ptable0, filters0, value0,
                               nsamples, mono=mono, nsteps=nsteps)
    return _lane_bytes(out), crc
