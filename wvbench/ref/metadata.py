"""Metadata sub-block TLV stream parsing.

Per reference MetadataUtils.cs:15-109: each sub-block is a 1-byte id plus a
length in 2-byte words (ID_LARGE extends the length field by 2 bytes;
ID_ODD_SIZE trims the final pad byte). The reference validates completeness
by comparing consumed bytes against ckSize (UnpackUtils.cs:45-49); we mirror
that via the `complete` flag.

Frozen copy for the benchmark, taken from wvpk_torch/container/metadata.py: the yardstick does not follow
later changes to the program, and imports nothing of it.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import consts
from .header import HEADER_SIZE, BlockHeader


@dataclass
class MetadataItem:
    id: int        # with ID_LARGE/ID_ODD_SIZE stripped
    data: bytes    # payload with odd-size pad byte removed
    # byte offset of the item's id byte relative to the block start
    # (always even: items are word-aligned). Used by the block-checksum
    # audit (container/checksum.py), which must know how many leading
    # block bytes the stored checksum covers.
    offset: int = -1


class MetadataError(ValueError):
    pass


def iter_metadata(data: bytes, hdr: BlockHeader) -> list[MetadataItem]:
    """Parse all metadata sub-blocks of the block starting at hdr.

    Raises MetadataError when the TLV stream does not exactly fill the block
    (the reference's "invalid reading WavPack metadata block" condition).
    """
    pos = hdr.stream_position + HEADER_SIZE
    end = hdr.stream_position + hdr.ck_size + 8
    items: list[MetadataItem] = []
    while pos < end:
        if pos + 2 > len(data):
            raise MetadataError("truncated metadata header")
        item_off = pos - hdr.stream_position
        mid = data[pos]
        byte_length = data[pos + 1] << 1
        pos += 2
        if mid & consts.ID_LARGE:
            mid &= ~consts.ID_LARGE & 0xFF
            if pos + 2 > len(data):
                raise MetadataError("truncated large metadata length")
            byte_length += (data[pos] << 9) + (data[pos + 1] << 17)
            pos += 2
        stored = byte_length
        if mid & consts.ID_ODD_SIZE:
            mid &= ~consts.ID_ODD_SIZE & 0xFF
            byte_length -= 1
        if pos + stored > len(data):
            raise MetadataError("truncated metadata payload")
        items.append(MetadataItem(id=mid, data=bytes(data[pos:pos + byte_length]),
                                  offset=item_off))
        pos += stored
    if pos != end:
        raise MetadataError("metadata does not fill block (ckSize mismatch)")
    return items
