"""DSF (DSD Stream File) container read/write for the DSD encode path.

No reference analog: the C# reference decodes DSD blocks but ships no
DSD container IO (its demo always emits RIFF WAV, WvDemo.cs:80-104).
wvpk stores the original DSF prefix/trailer verbatim in the .wv
(ID_ALT_HEADER / ID_ALT_TRAILER — the WavPack-5 alt-container slots
the parser already understands, container/blockstate.py) plus
ID_NEW_CONFIG_BLOCK's file_format, so decode reproduces the original
DSF byte-exactly.

Layout (DSF spec v1.01): "DSD " chunk (28 bytes: size, total file
size, metadata pointer), "fmt " chunk (52 bytes: version 1, format 0,
channel type/num, sampling frequency in Hz, bits per sample 1 or 8,
per-channel sample count, per-channel block size, reserved), "data"
chunk (12-byte header + channel-interleaved blocks of `block_size`
bytes, zero-padded at the tail). bits_per_sample == 1 stores DSD bits
LSB-first within each byte; WavPack's DSD domain is MSB-first, so
those bytes are bit-reversed on read and re-reversed on write (the
same convention libwavpack uses for DSF input).
"""

from __future__ import annotations

import struct

import numpy as np

# per-byte bit reversal table
_REV = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)


def reverse_bits(data: np.ndarray) -> np.ndarray:
    """MSB-first <-> LSB-first DSD byte conversion (involution)."""
    return _REV[np.asarray(data, np.uint8)]


def read_dsf(blob: bytes):
    """Parse a DSF file.

    Returns (data, dsd_rate, header, trailer): data is (n, ch) uint8
    byte-samples in WavPack's MSB-first DSD domain, dsd_rate the 1-bit
    sampling frequency in Hz, header the raw prefix through the data
    chunk header (stored verbatim in the .wv), trailer the metadata
    bytes after the sample data (or None).
    """
    if len(blob) < 92 or blob[:4] != b"DSD ":
        raise ValueError("not a DSF file")
    _, meta_ptr = struct.unpack("<QQ", blob[12:28])
    if blob[28:32] != b"fmt ":
        raise ValueError("DSF fmt chunk missing")
    (fmt_size, version, fmt_id, _ch_type, ch, rate, bits, count,
     block_size, _resv) = struct.unpack("<QIIIIIIQII", blob[32:80])
    if version != 1 or fmt_id != 0:
        raise ValueError(f"unsupported DSF version/format {version}/{fmt_id}")
    if bits not in (1, 8):
        raise ValueError(f"unsupported DSF bits per sample {bits}")
    if ch < 1 or block_size < 1:
        raise ValueError("bad DSF channel count / block size")
    # fmt chunk size counts its id + size fields (52 for v1)
    data_off = 28 + fmt_size
    if blob[data_off:data_off + 4] != b"data":
        raise ValueError("DSF data chunk missing")
    body = data_off + 12
    header = blob[:body]
    nbytes_ch = (count + 7) // 8 if bits == 1 else count
    nblocks = (nbytes_ch + block_size - 1) // block_size
    payload = np.frombuffer(
        blob[body:body + nblocks * block_size * ch], np.uint8)
    if payload.size < nblocks * block_size * ch:
        raise ValueError("truncated DSF data payload")
    # (nblocks, ch, block_size) channel-interleaved -> (n, ch)
    mat = payload.reshape(nblocks, ch, block_size) \
        .transpose(0, 2, 1).reshape(-1, ch)[:nbytes_ch]
    if bits == 1:
        mat = reverse_bits(mat)
    trailer = blob[meta_ptr:] if 0 < meta_ptr < len(blob) else None
    return np.ascontiguousarray(mat), rate, header, trailer


def parse_dsf_header(hdr: bytes):
    """Parse a saved DSF prefix (through the data chunk header) ->
    (ch, dsd_rate, bits, per-channel sample count, block_size)."""
    if len(hdr) < 80 or hdr[:4] != b"DSD " or hdr[28:32] != b"fmt ":
        raise ValueError("not a DSF header")
    (_sz, version, fmt_id, _ct, ch, rate, bits, count,
     block_size, _resv) = struct.unpack("<QIIIIIIQII", hdr[32:80])
    if version != 1 or fmt_id != 0 or bits not in (1, 8) or ch < 1 \
            or block_size < 1:
        raise ValueError("unsupported DSF header")
    return ch, rate, bits, count, block_size


def write_dsf_payload(data: np.ndarray, block_size: int = 4096,
                      lsb_first: bool = True) -> bytes:
    """(n, ch) MSB-first byte-samples -> DSF channel-interleaved block
    payload (zero-padded tail), bit-reversed back to the container's
    LSB-first order when lsb_first."""
    data = np.asarray(data, np.uint8)
    if data.ndim == 1:
        data = data[:, None]
    n, ch = data.shape
    if lsb_first:
        data = reverse_bits(data)
    nblocks = max(1, (n + block_size - 1) // block_size)
    pad = np.zeros((nblocks * block_size, ch), np.uint8)
    pad[:n] = data
    return pad.reshape(nblocks, block_size, ch) \
        .transpose(0, 2, 1).tobytes()


def make_dsf(data: np.ndarray, dsd_rate: int, trailer: bytes = b"",
             block_size: int = 4096) -> bytes:
    """Build a complete DSF file from (n, ch) MSB-first byte-samples."""
    data = np.asarray(data, np.uint8)
    if data.ndim == 1:
        data = data[:, None]
    n, ch = data.shape
    payload = write_dsf_payload(data, block_size)
    data_chunk = b"data" + struct.pack("<Q", 12 + len(payload))
    # channel type: 1 = mono, 2 = stereo, else the count itself
    ch_type = {1: 1, 2: 2}.get(ch, ch)
    fmt = b"fmt " + struct.pack("<QIIIIIIQII", 52, 1, 0, ch_type, ch,
                                dsd_rate, 1, n * 8, block_size, 0)
    total = 28 + len(fmt) + len(data_chunk) + len(payload) + len(trailer)
    meta_ptr = total - len(trailer) if trailer else 0
    head = b"DSD " + struct.pack("<QQQ", 28, total, meta_ptr)
    return head + fmt + data_chunk + payload + trailer


class DsfRewriter:
    """Incremental DSF payload writer for the decode CLI: append
    decoded (chunk, ch) MSB-first byte-samples, emit complete
    channel-interleaved blocks as they fill (memory O(block_size*ch)).
    The saved DSF header supplies everything else; `finish` pads the
    final block with zeros like the original writer did."""

    def __init__(self, out_f, ch: int, block_size: int = 4096,
                 lsb_first: bool = True):
        self.f = out_f
        self.ch = ch
        self.block_size = block_size
        self.lsb_first = lsb_first
        self.buf = np.zeros((0, ch), np.uint8)

    def append(self, mat: np.ndarray) -> None:
        self.buf = np.concatenate(
            [self.buf, np.asarray(mat, np.uint8).reshape(-1, self.ch)])
        full = len(self.buf) // self.block_size * self.block_size
        if full:
            self.f.write(write_dsf_payload(self.buf[:full],
                                           self.block_size,
                                           self.lsb_first))
            self.buf = self.buf[full:]

    def finish(self) -> None:
        if len(self.buf):
            self.f.write(write_dsf_payload(self.buf, self.block_size,
                                           self.lsb_first))
            self.buf = self.buf[:0]
