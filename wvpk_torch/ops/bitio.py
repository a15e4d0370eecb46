"""Bitstream primitives for the lane-parallel entropy decode (port of
wvpk/ops/bitio.py).

`pack_streams` stages each lane's payload on the host, as in wvpk: a
(L, W) array of little-endian 32-bit words padded with the 0xff EOF fill.
On the device the words travel as int32 bit patterns. PyTorch has no full
uint64 arithmetic, so the tensor helpers work on int64 values that stay
non-negative: `peek` returns exactly the 33 stream bits at a position,
which is every bit a decoder reads at once (a code, an error-limit search
or a wvx window is at most 32 bits, plus the sign bit; a run of 33 ones
is already an EOF break).

`mylog2_v` and `exp2s_v` are the format's fixed-point log2/exp2
(WordsUtils.cs:588-646) that the hybrid error limit runs on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..tables import EXP2_NP, LOG2_NP

EXTRA_PAD_WORDS = 8  # room for bounded post-EOF overreads
PEEK_BITS = 33
_MASK33 = (1 << PEEK_BITS) - 1


def _quantize_words(nwords: int) -> int:
    """Round the staged word capacity up to a coarse grid (>= 1/16
    granularity, min 32 words), as wvpk does: worst-case padding 6.25%,
    all of it the 0xff EOF fill the bitstream contract expects."""
    gran = 32
    while gran * 16 < nwords:
        gran *= 2
    return ((nwords + gran - 1) // gran) * gran


def pack_streams(payloads: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Pack per-lane byte payloads into a (L, W) uint32 array (LSB-first
    bit order within a word) padded with the 0xff EOF fill. Returns
    (words, nbits). Uses wvpk's native C stager when it builds (it returns
    None when it cannot), numpy otherwise: host staging only."""
    from ..native import pack_streams_native

    nbytes = max((len(p) for p in payloads), default=0)
    nwords = _quantize_words((nbytes + 3) // 4 + EXTRA_PAD_WORDS)
    out = pack_streams_native(payloads, nwords * 4)
    if out is None:
        out = np.full((len(payloads), nwords * 4), 0xFF, np.uint8)
        for i, p in enumerate(payloads):
            out[i, :len(p)] = np.frombuffer(p, np.uint8)
    words = out.view("<u4")
    nbits = np.asarray([len(p) * 8 for p in payloads], np.int32)
    return np.ascontiguousarray(words), nbits


def make_windows(words: torch.Tensor) -> torch.Tensor:
    """(L, W) int32 word bit patterns -> (L, W + 1) int64 words in
    [0, 2^32), with one more 0xffffffff EOF word so `peek` can always read
    the word after its position."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    pad = torch.full((w.shape[0], 1), 0xFFFFFFFF, dtype=torch.int64,
                     device=w.device)
    return torch.cat([w, pad], dim=1)


def peek(windows: torch.Tensor, bitpos: torch.Tensor) -> torch.Tensor:
    """The 33 stream bits starting at `bitpos`, per lane, as int64.

    Positions past the last staged word clamp to its start, as in wvpk."""
    max_bit = (windows.shape[1] - 2) * 32
    bp = torch.clamp(bitpos, max=max_bit)
    idx = bp >> 5
    s = bp & 31
    pair = torch.gather(windows, 1, torch.stack([idx, idx + 1], dim=1))
    lo, hi = pair[:, 0], pair[:, 1]
    return (lo >> s) | ((hi & ((2 << s) - 1)) << (32 - s))


def trailing_ones(win: torch.Tensor) -> torch.Tensor:
    """Count of consecutive low 1-bits of a 33-bit window (33 if all)."""
    y = ~win & _MASK33
    lsb = y & -y
    ctz = torch.frexp(lsb.to(torch.float64)).exponent.to(torch.int64) - 1
    return torch.where(y == 0, PEEK_BITS, ctz)


def bits_of(win: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Low n (clamped to 0..62, per lane) bits of the window."""
    one = torch.ones_like(n)
    return win & ((one << torch.clamp(n, 0, 62)) - 1)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """Truncate int64 to C# int32 wrap semantics, kept in int64."""
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def bit_length64(x: torch.Tensor) -> torch.Tensor:
    """bit_length of a non-negative int64 (== count_bits,
    WordsUtils.cs:513). float64 may round x up to the next power of two,
    which the shift test corrects."""
    e = torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)
    too_big = (x >> torch.clamp(e - 1, min=0)) == 0
    return torch.where(x > 0, e - too_big.to(torch.int64), 0)


@functools.lru_cache(maxsize=None)
def log2_exp2_tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    """The 256-entry log2 and exp2 tables as int64 tensors on `device`."""
    return tuple(torch.from_numpy(t.astype(np.int64)).to(device)
                 for t in (LOG2_NP, EXP2_NP))


def mylog2_v(av: torch.Tensor) -> torch.Tensor:
    """mylog2 (WordsUtils.cs:588-608) on int64 values."""
    av = av + (av >> 9)
    dbits = torch.where(av > 0, bit_length64(av), 0)
    sh = dbits - 9
    idx = torch.where(sh >= 0, av >> torch.clamp(sh, min=0),
                      av << torch.clamp(-sh, min=0)) & 0xFF
    return (dbits << 8) + log2_exp2_tables(av.device)[0][idx]


def exp2s_v(log: torch.Tensor) -> torch.Tensor:
    """exp2s (WordsUtils.cs:633-646) on int64 values, with the int32 wrap
    of its left-shift branch. A shift of 32 or more leaves no low bits of
    the 9-bit mantissa, so clamping the count to 32 is exact and keeps the
    int64 shift from overflowing."""
    a = torch.abs(log)
    v = log2_exp2_tables(log.device)[1][a & 0xFF] | 0x100
    sh = a >> 8
    r = torch.where(sh <= 9, v >> torch.clamp(9 - sh, 0, 63),
                    wrap32(v << torch.clamp(sh - 9, 0, 32)))
    return torch.where(log < 0, -r, r)
