"""Bitstream primitives for the lane-parallel entropy decode (port of
wvpk/ops/bitio.py).

`pack_streams` stages each lane's payload on the host, as in wvpk: a
(L, W) array of little-endian 32-bit words padded with the 0xff EOF fill.
On the device the words travel as int32 bit patterns. PyTorch has no full
uint64 arithmetic, so the tensor helpers work on int64 values that stay
non-negative: `peek` returns exactly the 33 stream bits at a position,
which is every bit the lossless decoder reads at once (a code is at most
28 bits plus its sign bit; a run of 33 ones is already an EOF break).
"""

from __future__ import annotations

import numpy as np
import torch

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
    from wvpk.native import pack_streams_native

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
