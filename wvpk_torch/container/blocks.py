"""Whole-file block index: header + metadata + decoded state per block.

The reference re-discovers blocks lazily while decoding
(WavPackUtils.cs:210-225); we index the whole container at open so that
(a) every block becomes an independent device lane, and (b) seek/resume is
O(1) (SURVEY.md section 5.4).
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import trace
from ..consts import MAX_BLOCK_SAMPLES
from .blockstate import BlockState, ContextUpdates, decode_block_state
from .header import HEADER_SIZE, BlockHeader, scan_headers
from .metadata import MetadataItem, iter_metadata


@dataclass
class Block:
    header: BlockHeader
    items: list[MetadataItem]
    state: BlockState
    updates: ContextUpdates


def pair_wvc(blocks: list[Block], wvc_data: bytes) -> int:
    """Attach a .wvc correction file's per-block payloads to the audio
    blocks (hybrid-lossless decode, beyond reference parity: the
    reference opens only the main file and notes "Correction files are
    not handled", WavPackUtils.cs:31).

    Correction blocks are full wvpk blocks carrying ID_WVC_BITSTREAM,
    written 1:1 and in order with the main file's audio blocks; pairing
    is sequential with a (block_index, block_samples) sanity match.
    Unmatched audio blocks simply stay lossy — the decoder falls back to
    plain hybrid for them. Returns the number of blocks paired."""
    from .. import consts

    corr: list[tuple[BlockHeader, bytes]] = []
    for hdr in scan_headers(wvc_data):
        if hdr.block_samples <= 0 or hdr.block_samples > MAX_BLOCK_SAMPLES:
            continue
        if hdr.stream_position + hdr.ck_size + 8 > len(wvc_data):
            continue
        try:
            items = iter_metadata(wvc_data, hdr)
        except Exception:
            continue
        for it in items:
            if it.id == consts.ID_WVC_BITSTREAM:
                corr.append((hdr, it.data))
                break

    paired = 0
    ci = 0
    for blk in blocks:
        if blk.header.block_samples <= 0 or ci >= len(corr):
            continue
        chdr, payload = corr[ci]
        if (chdr.block_index != blk.header.block_index
                or chdr.block_samples != blk.header.block_samples):
            continue
        ci += 1
        if not (blk.state.flags & consts.HYBRID_FLAG):
            continue                      # lossless blocks need no correction
        blk.state.wvcbits = payload
        blk.state.wvc_crc = chdr.crc
        paired += 1
    return paired


@trace.stage("parse")
def parse_blocks(data: bytes, strict: bool = False) -> list[Block]:
    """Index every decodable block. Truncated or metadata-corrupt blocks
    are skipped (their sample range gap-fills as zeros downstream) — the
    reference stops decoding at the first such block
    (WavPackUtils.cs:216-221); continuing past it is a recovery
    improvement, `strict=True` restores raise-on-error.

    PCM blocks without context-update metadata parse through the native C
    walker (wvpk_parse_block, ~10x the Python walk); DSD blocks, blocks
    carrying context updates (config/riff/channel info) and malformed
    blocks take the exact-semantics Python path. Traced as the `parse`
    span, counting the blocks returned and those that took the Python
    path (`#blocks`, `#python_blocks`)."""
    from ..native import parse_block_native
    from .blockstate import state_from_native

    blocks = []
    python_blocks = 0
    for hdr in scan_headers(data):
        if hdr.stream_position + hdr.ck_size + 8 > len(data):
            if strict:
                raise ValueError("truncated trailing block")
            continue
        if hdr.block_samples > MAX_BLOCK_SAMPLES:
            # corrupt header (consts.MAX_BLOCK_SAMPLES rationale):
            # conceal like any other malformed block
            if strict:
                raise ValueError(
                    f"block_samples {hdr.block_samples} exceeds the "
                    f"engine cap {MAX_BLOCK_SAMPLES}")
            continue
        arr = None if strict else parse_block_native(data,
                                                     hdr.stream_position)
        if arr is not None:
            state, updates = state_from_native(hdr, arr, data)
            blocks.append(Block(hdr, [], state, updates))
            continue
        python_blocks += 1
        try:
            items = iter_metadata(data, hdr)
            state, updates = decode_block_state(hdr, items)
        except Exception:
            if strict:
                raise
            continue
        blocks.append(Block(hdr, items, state, updates))
    trace.count("blocks", len(blocks))
    trace.count("python_blocks", python_blocks)
    return blocks
