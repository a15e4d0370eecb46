"""The byte counts behind both rooflines, against examples worked by
hand."""

from __future__ import annotations

import numpy as np
import pytest

from wvbench import ops, roofline
from wvbench.inputs import File
from wvbench.ref import consts
from wvbench.ref.files import payload_bytes


def _block(items: list[tuple[int, bytes]], block_samples: int = 10) -> bytes:
    """A block by hand: a 32-byte header, then each metadata item as
    (id, 1 byte of size in words, payload padded to even)."""
    body = b""
    for mid, data in items:
        odd = len(data) & 1
        body += bytes([mid | (consts.ID_ODD_SIZE if odd else 0),
                       (len(data) + odd) // 2]) + data + b"\0" * odd
    hdr = bytearray(32)
    hdr[0:4] = b"wvpk"
    hdr[4:8] = (24 + len(body)).to_bytes(4, "little")
    hdr[8:10] = (0x410).to_bytes(2, "little")
    hdr[12:16] = (20).to_bytes(4, "little")
    hdr[20:24] = block_samples.to_bytes(4, "little")
    hdr[24:28] = (1 | consts.INITIAL_BLOCK | consts.FINAL_BLOCK).to_bytes(
        4, "little")
    return bytes(hdr) + body


def test_payload_bytes_counts_the_named_item_only():
    a = _block([(consts.ID_DECORR_TERMS, b"\x01\x02"),
                (consts.ID_WV_BITSTREAM, b"abcdef")])
    b = _block([(consts.ID_WV_BITSTREAM, b"ghi")])     # 3 bytes, odd
    assert payload_bytes(a + b, consts.ID_WV_BITSTREAM) == 6 + 3
    assert payload_bytes(a + b, consts.ID_WVC_BITSTREAM) == 0


def test_decode_and_encode_bytes_by_hand():
    # 1,000 stereo 16-bit frames and a payload of 1,500 bytes
    assert roofline.decode_bytes(1500, 1000, 2, 2) == 5500
    assert roofline.encode_bytes(1000, 2, 2, 2500) == 6500
    # 3.35e12 bytes take one second at the peak: half of 2 s is 50 %
    assert roofline.roofline_pct(3_350_000_000_000, 2.0) == pytest.approx(50)
    assert roofline.roofline_pct(10, 0.0) is None


def test_a_call_counts_each_of_its_files():
    config = {"bits_per_sample": 16, "channels": 2}
    pcm = np.zeros((100, 2), np.int16)
    files = [File(0, 100, pcm, payload=30),
             File(1, 50, pcm[:50], payload=10)]
    # decode: (30 + 400) + (10 + 200)
    assert ops.call_bytes("decode", files, None, config) == 640
    # encode: (400 + 7) + (200 + 3)
    assert ops.call_bytes("encode", files, [b"x" * 7, b"y" * 3],
                          config) == 610
    assert ops.frames(files) == 150
