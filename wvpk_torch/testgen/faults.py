"""Fault injection (SURVEY.md section 5.3 test mode).

Deterministic corruption tools for exercising the three recovery tiers the
format defines: header resync (WavPackUtils.cs:651-669), per-block CRC
(UnpackUtils.cs:1414-1421), and mute concealment (UnpackUtils.cs:649-664 /
DsdUtils.cs:104-117).
"""

from __future__ import annotations

import numpy as np

from ..container.header import HEADER_SIZE, scan_headers


def flip_bits(data: bytes, positions: list[tuple[int, int]]) -> bytes:
    """Flip (byte_offset, bit) positions."""
    out = bytearray(data)
    for off, bit in positions:
        out[off] ^= 1 << bit
    return bytes(out)


def corrupt_block_payload(data: bytes, block_idx: int = 0,
                          nflips: int = 4, seed: int = 0) -> bytes:
    """Flip random bits inside one block's metadata payload region."""
    hdrs = scan_headers(data)
    h = hdrs[block_idx]
    lo = h.stream_position + HEADER_SIZE + 8
    hi = h.stream_position + h.ck_size + 8 - 1
    rng = np.random.default_rng(seed)
    pos = [(int(rng.integers(lo, hi)), int(rng.integers(0, 8)))
           for _ in range(nflips)]
    return flip_bits(data, pos)


def corrupt_header_magic(data: bytes, block_idx: int) -> bytes:
    """Destroy a block header's magic so the scanner must resync past it."""
    hdrs = scan_headers(data)
    off = hdrs[block_idx].stream_position
    out = bytearray(data)
    out[off:off + 4] = b"XXXX"
    return bytes(out)


def truncate(data: bytes, keep_fraction: float) -> bytes:
    return data[: int(len(data) * keep_fraction)]


def prepend_garbage(data: bytes, nbytes: int = 97, seed: int = 1) -> bytes:
    rng = np.random.default_rng(seed)
    junk = bytes(int(x) for x in rng.integers(0, 256, nbytes))
    return junk.replace(b"wvpk", b"wvpj") + data
