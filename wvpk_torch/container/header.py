"""WavPack 32-byte block header scan/parse.

Semantics per reference WavPackUtils.cs:600-671 (`read_next_header`): scan
forward for the 'wvpk' magic with sanity checks, resync up to 1 MiB of
garbage, parse WavPack5 40-bit total_samples/block_index (high bytes live at
offsets 11/10).
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import consts

HEADER_SIZE = 32
MAX_RESYNC_BYTES = 1048576


@dataclass
class BlockHeader:
    ck_size: int          # block size minus 8 (uint32)
    version: int
    total_samples: int    # 40-bit; 0xFFFFFFFF low word means "unknown"
    block_index: int      # 40-bit
    block_samples: int    # uint32
    flags: int            # uint32 bitfield
    crc: int              # int32 (signed, to match running-CRC wrap compare)
    stream_position: int  # byte offset of this header in the file

    @property
    def is_mono_data(self) -> bool:
        return bool(self.flags & consts.MONO_DATA)

    @property
    def is_initial(self) -> bool:
        return bool(self.flags & consts.INITIAL_BLOCK)

    @property
    def is_final(self) -> bool:
        return bool(self.flags & consts.FINAL_BLOCK)

    @property
    def end_index(self) -> int:
        return self.block_index + self.block_samples


def _valid_magic(b: bytes, i: int) -> bool:
    # magic + sanity: ckSize even and < 1 MiB, reserved byte zero, version
    # in [MIN_STREAM_VERS, MAX_STREAM_VERS] with major byte 4
    # (WavPackUtils.cs:632).
    return (b[i:i + 4] == b"wvpk" and (b[i + 4] & 1) == 0 and b[i + 6] < 16
            and b[i + 7] == 0 and b[i + 9] == 4
            and (consts.MIN_STREAM_VERS & 0xFF) <= b[i + 8] <= (consts.MAX_STREAM_VERS & 0xFF))


def _parse_at(b: bytes, i: int) -> BlockHeader:
    crc = int.from_bytes(b[i + 28:i + 32], "little")
    if crc >= 0x80000000:
        crc -= 0x100000000
    return BlockHeader(
        ck_size=int.from_bytes(b[i + 4:i + 8], "little"),
        version=int.from_bytes(b[i + 8:i + 10], "little"),
        total_samples=(b[i + 11] << 32) | int.from_bytes(b[i + 12:i + 16], "little"),
        block_index=(b[i + 10] << 32) | int.from_bytes(b[i + 16:i + 20], "little"),
        block_samples=int.from_bytes(b[i + 20:i + 24], "little"),
        flags=int.from_bytes(b[i + 24:i + 28], "little"),
        crc=crc,
        stream_position=i,
    )


def read_next_header(data: bytes, pos: int) -> BlockHeader | None:
    """Scan `data` from `pos` for the next valid header; None on EOF/1MiB."""
    skipped = 0
    n = len(data)
    while pos + HEADER_SIZE <= n:
        if data[pos] == 0x77 and _valid_magic(data, pos):  # 'w'
            return _parse_at(data, pos)
        pos += 1
        skipped += 1
        if skipped > MAX_RESYNC_BYTES:
            return None
    return None


def scan_headers(data: bytes) -> list[BlockHeader]:
    """Full-file header index (O(1) seek / resume support).

    Unlike the reference's iterative estimate-based seek
    (WavPackUtils.cs:504-594), we index every block at open; the scan is a
    cheap host pass and makes any block a checkpoint. Uses the native C
    scanner (wvpk/native) when available.
    """
    try:
        from ..native import scan_headers_native
        fields = scan_headers_native(data)
    except Exception:
        fields = None
    if fields is not None:
        return [BlockHeader(ck_size=int(f[0]), version=int(f[1]),
                            total_samples=int(f[2]), block_index=int(f[3]),
                            block_samples=int(f[4]), flags=int(f[5]),
                            crc=int(f[6]), stream_position=int(f[7]))
                for f in fields]
    out: list[BlockHeader] = []
    pos = 0
    while True:
        hdr = read_next_header(data, pos)
        if hdr is None:
            return out
        out.append(hdr)
        # ckSize counts from byte 8 of the header.
        pos = hdr.stream_position + hdr.ck_size + 8
