"""WavPack numeric primitives: signed-log16 codec, weight restore, bit counts.

These implement the format's "base-2 logarithm" fixed-point encoding and the
entropy coder's helper tables. Semantics match the reference decoder
(reference: WordsUtils.cs:33-66 tables, :513-661 helpers); the 256-entry
log2/exp2 tables are generated from their defining formulas
round(256*log2(1+i/256)) and round(256*(2^(i/256)-1)), verified equal to the
format's canonical tables.
"""

from __future__ import annotations

import math

import numpy as np

LOG2_TABLE = tuple(round(256 * math.log2(1 + i / 256)) for i in range(256))
EXP2_TABLE = tuple(round(256 * (2 ** (i / 256) - 1)) for i in range(256))
# trailing-ones count of each byte value (WordsUtils.cs:57-66)
ONES_COUNT_TABLE = tuple((~i & -~i).bit_length() - 1 if i != 0xFF else 8
                         for i in range(256))
# bit_length of each byte value (WordsUtils.cs:33-51)
NBITS_TABLE = tuple(i.bit_length() for i in range(256))

LOG2_NP = np.asarray(LOG2_TABLE, dtype=np.int32)
EXP2_NP = np.asarray(EXP2_TABLE, dtype=np.int32)
ONES_COUNT_NP = np.asarray(ONES_COUNT_TABLE, dtype=np.int32)


def i32(x: int) -> int:
    """Wrap a Python int to signed 32-bit (C# int truncation semantics)."""
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


def u32(x: int) -> int:
    return x & 0xFFFFFFFF


def i64(x: int) -> int:
    """Wrap to signed 64-bit (C# long)."""
    x &= 0xFFFFFFFFFFFFFFFF
    return x - 0x10000000000000000 if x >= 0x8000000000000000 else x


def i16(x: int) -> int:
    """Wrap to signed 16-bit (C# (short) cast)."""
    x &= 0xFFFF
    return x - 0x10000 if x >= 0x8000 else x


def count_bits(av: int) -> int:
    """Number of bits needed for av (== av.bit_length() for av >= 0).

    Mirrors reference WordsUtils.cs:513-537.
    """
    return av.bit_length()


def mylog2(avalue: int) -> int:
    """Fixed-point log2 of a 32-bit unsigned value (WordsUtils.cs:588-608).

    Input up to ~0xff800000; output 0..8447 with 8 fractional bits.
    """
    avalue += avalue >> 9
    if avalue < (1 << 8):
        dbits = NBITS_TABLE[avalue]
        return (dbits << 8) + LOG2_TABLE[(avalue << (9 - dbits)) & 0xFF]
    if avalue < (1 << 16):
        dbits = NBITS_TABLE[avalue >> 8] + 8
    elif avalue < (1 << 24):
        dbits = NBITS_TABLE[avalue >> 16] + 16
    else:
        dbits = NBITS_TABLE[(avalue >> 24) & 0xFF] + 24
    return (dbits << 8) + LOG2_TABLE[(avalue >> (dbits - 9)) & 0xFF]


def log2s(value: int) -> int:
    """Signed fixed-point log2 (WordsUtils.cs:615-625); range +/-8192."""
    return -mylog2(-value) if value < 0 else mylog2(value)


def exp2s(log: int) -> int:
    """Inverse of log2s (WordsUtils.cs:633-646); input -8192..+8447."""
    if log < 0:
        return -exp2s(-log)
    value = EXP2_TABLE[log & 0xFF] | 0x100
    log >>= 8
    if log <= 9:
        return value >> (9 - log)
    return i32(value << (log - 9))


def restore_weight(weight: int) -> int:
    """int8 metadata weight -> internal +/-1024 weight (WordsUtils.cs:653-661).

    `weight` is interpreted as a signed byte.
    """
    if weight >= 0x80:
        weight -= 0x100
    result = weight << 3
    if result > 0:
        result += (result + 64) >> 7
    return result


def store_weight(weight: int) -> int:
    """Inverse of restore_weight for the encoder: internal weight -> signed byte.

    Matches libwavpack's store_weight semantics: clip to +/-1024, round to
    8-bit storage such that restore_weight(store_weight(w)) is the canonical
    dequantized weight.
    """
    if weight > 1024:
        weight = 1024
    elif weight < -1024:
        weight = -1024
    if weight > 0:
        weight -= (weight + 64) >> 7
    return ((weight + 4) >> 3) & 0xFF
