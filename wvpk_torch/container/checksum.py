"""WavPack 5 block checksums (ID_BLOCK_CHECKSUM) — opt-in integrity audit.

The C# reference only notes the item's presence to set the WavPack-5 flag
(MetadataUtils.cs:184-186) and never validates it; wvpk's DECODE semantics
match that exactly (blockstate.py sets `five` and moves on). This module
adds verification as an extension, modeled on libwavpack 5's scheme:

  - the checksum covers every block byte BEFORE the checksum item's own
    2-byte metadata header (so: the 32-byte block header, all preceding
    metadata items, and nothing of the checksum item itself);
  - those bytes are folded as little-endian 16-bit words into
    ``csum = csum * 3 + word`` (mod 2**32) starting from 0xFFFFFFFF;
  - a 4-byte item stores csum; a 2-byte item stores
    ``(csum ^ (csum >> 16)) & 0xFFFF``.

The fold is a linear recurrence, so it vectorizes:
``csum = 0xFFFFFFFF * 3**n + sum(word[i] * 3**(n-1-i))  (mod 2**32)``
with the powers of three precomputed once in wrap-around uint32.

By convention the item is the LAST one in a block, letting writers stamp
it after everything else (``add_block_checksum``); the verifier accepts it
at any position since coverage is defined by the item's own offset.
"""

from __future__ import annotations

import numpy as np

from .. import consts
from .header import BlockHeader, read_next_header
from .metadata import MetadataError, MetadataItem, iter_metadata

_POW3 = np.ones(1, dtype=np.uint32)  # _POW3[k] = 3**k mod 2**32, grown on demand


def _pow3(n: int) -> np.ndarray:
    global _POW3
    if len(_POW3) <= n:
        m = max(n + 1, 2 * len(_POW3))
        p = np.empty(m, dtype=np.uint32)
        p[0] = 1
        np.multiply.accumulate(np.full(m - 1, 3, dtype=np.uint32), out=p[1:])
        _POW3 = p
    return _POW3


def compute_block_checksum(data: bytes, start: int, upto: int) -> int:
    """csum*3+word fold over data[start:start+upto] (upto even), init -1."""
    if upto & 1:
        raise ValueError("block checksum coverage must be word-aligned")
    w = np.frombuffer(data, dtype="<u2", count=upto >> 1,
                      offset=start).astype(np.uint32)
    n = len(w)
    p = _pow3(n)
    if n:
        acc = int((w * p[n - 1::-1][:n]).sum(dtype=np.uint32))
    else:
        acc = 0
    return (0xFFFFFFFF * int(p[n]) + acc) & 0xFFFFFFFF


def _expected(csum: int, width: int) -> int:
    if width == 2:
        return (csum ^ (csum >> 16)) & 0xFFFF
    return csum


def verify_block_checksum(data: bytes, hdr: BlockHeader | None = None,
                          items: list[MetadataItem] | None = None
                          ) -> bool | None:
    """Verify one block's stored checksum.

    `data` is a buffer holding the whole block (plus anything around it);
    `hdr` locates the block (defaults to the first header in `data`).
    Returns True/False for a well-formed 2/4-byte checksum item, or None
    when the block stores no (usable) checksum — absence is not an error,
    matching the reference's indifference to the item.
    """
    if hdr is None:
        hdr = read_next_header(data, 0)
        if hdr is None:
            raise MetadataError("no WavPack block header found")
    if items is None:
        try:
            items = iter_metadata(data, hdr)
        except MetadataError:
            # an audit must not crash on the corruption it exists to find:
            # an unparseable TLV stream is an integrity failure
            return False
    for it in items:
        if it.id != consts.ID_BLOCK_CHECKSUM:
            continue
        width = len(it.data)
        if width not in (2, 4) or it.offset < 0 or (it.offset & 1):
            return None
        csum = compute_block_checksum(data, hdr.stream_position, it.offset)
        stored = int.from_bytes(it.data[:width], "little")
        return _expected(csum, width) == stored
    return None


def add_block_checksum(block: bytes, width: int = 4) -> bytes:
    """Append an ID_BLOCK_CHECKSUM item (2 or 4 bytes) to a standalone
    block, fixing up ckSize. Safe to call after CRC stamping: the header
    CRC covers decoded samples, not raw block bytes."""
    if width not in (2, 4):
        raise ValueError("block checksum width must be 2 or 4")
    blk = bytearray(block)
    blk += bytes([consts.ID_BLOCK_CHECKSUM, width >> 1]) + bytes(width)
    ck_size = int.from_bytes(blk[4:8], "little") + width + 2
    blk[4:8] = ck_size.to_bytes(4, "little")
    csum = compute_block_checksum(bytes(blk), 0, len(blk) - width - 2)
    blk[-width:] = _expected(csum, width).to_bytes(width, "little")
    return bytes(blk)


def verify_file_checksums(data: bytes | str) -> tuple[int, int, int]:
    """Audit every block in a file image: (ok, bad, absent) counts.

    Accepts in-memory bytes or a path; a path is memory-mapped so the
    audit streams multi-GB files at constant RSS."""
    if isinstance(data, str):
        import mmap
        with open(data, "rb") as f:
            with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
                return verify_file_checksums(mm)
    ok = bad = absent = 0
    pos = 0
    while True:
        hdr = read_next_header(data, pos)
        if hdr is None:
            break
        res = verify_block_checksum(data, hdr)
        if res is None:
            absent += 1
        elif res:
            ok += 1
        else:
            bad += 1
        pos = hdr.stream_position + 8 + hdr.ck_size
    return ok, bad, absent
