"""Host-side container layer: block headers, metadata TLV, block state.

This is the reference's L2/L3 (header scan WavPackUtils.cs:600-671, metadata
TLV MetadataUtils.cs:15-193, block-state init UnpackUtils.cs:24-491 +
WordsUtils.cs:75-187 + FloatUtils.cs:15-30 + DsdUtils.cs:17-54). Everything
here is cheap host Python; sample-domain math lives on device.
"""

from .header import BlockHeader, read_next_header, scan_headers
from .metadata import MetadataItem, iter_metadata
from .blockstate import BlockState, DsdState, decode_block_state
from .blocks import Block, parse_blocks
from .checksum import (add_block_checksum, verify_block_checksum,
                       verify_file_checksums)

__all__ = [
    "BlockHeader", "read_next_header", "scan_headers",
    "MetadataItem", "iter_metadata",
    "BlockState", "DsdState", "decode_block_state",
    "Block", "parse_blocks",
    "add_block_checksum", "verify_block_checksum", "verify_file_checksums",
]
