"""Bounded-memory streaming container access.

The reference decodes from a BinaryReader with incremental refill
(BitsUtils.cs:95-146, MetadataUtils.cs:25-26) and never holds the file in
memory. The eager path here (blocks.parse_blocks) loads + parses the whole
file at open, which is right for batch throughput but not for multi-GB
single files. This module provides the streaming equivalent:

- `scan_headers_file`: chunked whole-file header scan (32-byte headers
  only, ~0.4% of the file for 4k-sample blocks) — the block index that
  makes every block a checkpoint stays O(blocks), not O(bytes).
- `LazyBlocks`: a sequence view that reads + parses one block's payload
  on demand (seek/read of ck_size+8 bytes), behind a bounded LRU, so
  resident payload memory is O(batch), like the reference's reader.

Departure from wvpk/container/stream.py: `LazyBlocks.attach_wvc` pairs a
correction block only when its whole block lies inside the `.wvc` file,
the bounds check `blocks.pair_wvc` makes; wvpk's copy pairs on the header
alone, so with a truncated `.wvc` it counts the cut-off blocks as paired
and reports MODE_WVC | MODE_LOSSLESS for blocks that decode lossy.
"""

from __future__ import annotations

import io
from collections import OrderedDict
from dataclasses import replace

from ..consts import MAX_BLOCK_SAMPLES
from .blocks import Block
from .blockstate import decode_block_state
from .header import HEADER_SIZE, MAX_RESYNC_BYTES, BlockHeader, _parse_at, \
    _valid_magic
from .metadata import iter_metadata


def scan_headers_file(f: io.BufferedIOBase,
                      chunk_size: int = 8 << 20) -> list[BlockHeader]:
    """Chunked header scan of a seekable binary file. Same semantics as
    header.scan_headers (magic + sanity checks, jump by ck_size + 8,
    resync over garbage) without loading the file; the resync cap applies
    per contiguous garbage run."""
    f.seek(0)
    out: list[BlockHeader] = []
    buf = b""
    base = 0          # file offset of buf[0]
    pos = 0           # scan offset relative to buf
    skipped = 0       # garbage run length (resync cap)

    def ensure(k: int) -> bool:
        """Grow/slide buf so [pos, pos+k) is resident; False at EOF.
        A block jump can land past the buffered bytes — seek there
        instead of slicing (slicing would desynchronize base from the
        file position)."""
        nonlocal buf, base, pos
        if pos >= len(buf):
            base += pos
            f.seek(base)
            buf = b""
            pos = 0
        elif pos > chunk_size:
            base += pos
            buf = buf[pos:]
            pos = 0
        while pos + k > len(buf):
            data = f.read(chunk_size)
            if not data:
                return pos + k <= len(buf)
            buf += data
        return True

    while ensure(HEADER_SIZE):
        if buf[pos] == 0x77 and _valid_magic(buf, pos):  # 'w'
            hdr = _parse_at(buf, pos)
            hdr.stream_position = base + pos
            # this index doubles as the decode admission list (segment
            # ranges come straight from it), so a corrupt-header sample
            # count must not enter it (consts.MAX_BLOCK_SAMPLES; eager
            # parse_blocks applies the same cap) — still jump its
            # payload, the framing is intact
            if hdr.block_samples <= MAX_BLOCK_SAMPLES:
                out.append(hdr)
            pos += hdr.ck_size + 8
            skipped = 0
        else:
            pos += 1
            skipped += 1
            if skipped > MAX_RESYNC_BYTES:
                break
    return out


class WvcReader:
    """Bounded-memory view of a `.wvc` correction file: eager header
    index, per-block ID_WVC_BITSTREAM payload extracted on demand (the
    streaming mirror of blocks.pair_wvc; hybrid-lossless is beyond
    reference parity, WavPackUtils.cs:31)."""

    def __init__(self, f: io.BufferedIOBase):
        self._f = f
        self.entries = [h for h in scan_headers_file(f)
                        if h.block_samples > 0]
        self.size = f.seek(0, io.SEEK_END)

    def whole(self, ordinal: int) -> bool:
        """Whether the ordinal-th correction block lies inside the file."""
        hdr = self.entries[ordinal]
        return hdr.stream_position + hdr.ck_size + 8 <= self.size

    def payload(self, ordinal: int):
        """(payload bytes | None, header) for the ordinal-th correction
        block."""
        from .. import consts
        hdr = self.entries[ordinal]
        self._f.seek(hdr.stream_position)
        raw = self._f.read(hdr.ck_size + 8)
        if len(raw) < hdr.ck_size + 8:
            return None, hdr
        try:
            for it in iter_metadata(raw, replace(hdr, stream_position=0)):
                if it.id == consts.ID_WVC_BITSTREAM:
                    return it.data, hdr
        except Exception:
            pass
        return None, hdr

    def close(self) -> None:
        self._f.close()


class LazyBlocks:
    """Sequence of Blocks parsed on demand from an open file.

    `headers` is the eager index (cheap); payload bytes + metadata parse
    happen per `__getitem__`, held in an LRU of `cache_blocks` entries.
    Raises BlockParseError for corrupt blocks — callers conceal them
    (zero-fill + mute) just like CRC failures."""

    def __init__(self, f: io.BufferedIOBase, headers: list[BlockHeader],
                 cache_blocks: int = 1024):
        self._f = f
        self.headers = headers
        self._cap = max(cache_blocks, 8)
        self._cache: OrderedDict[int, Block] = OrderedDict()
        self._wvc: WvcReader | None = None
        self._wvc_ordinal: dict[int, int] = {}

    def attach_wvc(self, reader: WvcReader) -> int:
        """Pair correction blocks with this file's audio blocks (by
        order, with a (block_index, block_samples) sanity match against
        the eager header index). A correction block cut off by the end of
        the file is left out, as `blocks.pair_wvc` leaves it out. Payload
        reads stay lazy; returns the number of audio blocks that will
        decode hybrid-lossless."""
        from .. import consts

        self._wvc = reader
        self._wvc_ordinal = {}
        self._cache.clear()   # re-parse any cached blocks with pairing
        whole = [k for k in range(len(reader.entries)) if reader.whole(k)]
        ci = paired = 0
        for i, h in enumerate(self.headers):
            if h.block_samples <= 0 or ci >= len(whole):
                continue
            c = reader.entries[whole[ci]]
            if (c.block_index != h.block_index
                    or c.block_samples != h.block_samples):
                continue
            ci += 1
            if h.flags & consts.HYBRID_FLAG:
                self._wvc_ordinal[i] = whole[ci - 1]
                paired += 1
        return paired

    def __len__(self) -> int:
        return len(self.headers)

    def header(self, i: int) -> BlockHeader:
        return self.headers[i]

    def __getitem__(self, i: int) -> Block:
        if i in self._cache:
            self._cache.move_to_end(i)
            return self._cache[i]
        hdr = self.headers[i]
        if hdr.block_samples > MAX_BLOCK_SAMPLES:
            # corrupt header (consts.MAX_BLOCK_SAMPLES rationale):
            # conceal like any other malformed block
            raise BlockParseError(
                f"block_samples {hdr.block_samples} exceeds the "
                f"engine cap {MAX_BLOCK_SAMPLES}")
        self._f.seek(hdr.stream_position)
        raw = self._f.read(hdr.ck_size + 8)
        if len(raw) < hdr.ck_size + 8:
            raise BlockParseError(f"truncated block at {hdr.stream_position}")
        local = replace(hdr, stream_position=0)
        # native C metadata walk first (~10x the Python walk — the
        # streaming hot loop parses every block exactly once); blocks
        # with context updates / DSD / malformed fall back to Python
        blk = None
        try:
            from ..native import parse_block_native
            from .blockstate import state_from_native
            arr = parse_block_native(raw, 0)
            if arr is not None:
                state, updates = state_from_native(hdr, arr, raw)
                blk = Block(hdr, [], state, updates)
        except Exception:
            blk = None
        if blk is None:
            try:
                items = iter_metadata(raw, local)
                state, updates = decode_block_state(hdr, items)
            except Exception as e:
                raise BlockParseError(str(e)) from e
            blk = Block(hdr, items, state, updates)
        o = self._wvc_ordinal.get(i)
        if o is not None:
            payload, chdr = self._wvc.payload(o)
            if payload is not None:
                blk.state.wvcbits = payload
                blk.state.wvc_crc = chdr.crc
        self._cache[i] = blk
        while len(self._cache) > self._cap:
            self._cache.popitem(last=False)
        return blk

    def close(self) -> None:
        self._f.close()


class BlockParseError(Exception):
    pass
