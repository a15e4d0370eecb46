"""The reference's view of whole `.wv` / `.wvc` files: the blocks it
indexes, the payload bytes the rooflines count, a block decoded alone
(each WavPack block seeds itself), and the block CRC in closed form.
Pure Python and NumPy."""

from __future__ import annotations

import numpy as np

from . import consts
from .blockstate import decode_block_state
from .header import scan_headers
from .metadata import iter_metadata
from .oracle import unpack_samples


def block_spans(data: bytes) -> list[tuple[int, int, int, int]]:
    """(byte start, byte end, block_index, block_samples) of every block
    in a stream, in order."""
    return [(h.stream_position, h.stream_position + h.ck_size + 8,
             h.block_index, h.block_samples) for h in scan_headers(data)]


def payload_bytes(data: bytes, item_id: int) -> int:
    """Sum over the stream's blocks of the bytes of metadata item
    `item_id` (consts.ID_WV_BITSTREAM, consts.ID_WVC_BITSTREAM)."""
    total = 0
    for hdr in scan_headers(data):
        for it in iter_metadata(data, hdr):
            if it.id == item_id:
                total += len(it.data)
    return total


def decode_alone(block: bytes, wvc_block: bytes | None = None
                 ) -> tuple[np.ndarray, bool, bool]:
    """One block's samples ((n, 2) int32 for stereo), crc_error and
    mute_error, by the scalar oracle; a correction block, when given, is
    paired as libwavpack does (hybrid-lossless)."""
    hdr = scan_headers(block)[0]
    st, _ = decode_block_state(hdr, iter_metadata(block, hdr))
    if wvc_block is not None:
        chdr = scan_headers(wvc_block)[0]
        if (chdr.block_index, chdr.block_samples) != (hdr.block_index,
                                                      hdr.block_samples):
            raise ValueError("correction block does not match its block")
        for it in iter_metadata(wvc_block, chdr):
            if it.id == consts.ID_WVC_BITSTREAM:
                st.wvcbits = it.data
                st.wvc_crc = chdr.crc
    res = unpack_samples(st)
    return res.samples, bool(res.crc_error), bool(res.mute_error)


def block_crc(final: np.ndarray) -> int:
    """WavPack's block CRC of the final (joint-undone) samples, (n, ch):
    crc = crc * 3 + x over the interleaved values from 0xffffffff, as a
    closed form in uint32 arithmetic."""
    x = final.astype(np.int64).reshape(-1).astype(np.uint32)
    m = x.size
    if m == 0:
        return 0xFFFFFFFF
    p = np.full(m, 3, np.uint32)
    p[0] = 1
    p = np.multiply.accumulate(p)
    acc = int(np.add.reduce(p[::-1] * x, dtype=np.uint32))
    return (acc + pow(3, m, 1 << 32) * 0xFFFFFFFF) & 0xFFFFFFFF

