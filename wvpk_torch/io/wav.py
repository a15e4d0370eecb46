"""RIFF WAV emission (reference ChunkHeader.cs / RiffChunkHeader.cs /
WaveHeader.cs and the demo's header synthesis WvDemo.cs:80-104) and a
WAV reader for the encode path (no reference analog: the reference is
decode-only)."""

from __future__ import annotations

import struct

import numpy as np


def make_wav_header(total_samples: int, num_channels: int, sample_rate: int,
                    bits_per_sample: int, bytes_per_sample: int,
                    fmt_tag: int = 1) -> bytes:
    """fmt_tag 1 = integer PCM (the reference demo's synthesis,
    WvDemo.cs:80-104); 3 = IEEE float32 (extension for the float
    encode/decode path — the reference always emits integer WAVs)."""
    block_align = bytes_per_sample * num_channels
    data_size = total_samples * block_align
    riff = b"RIFF" + struct.pack("<I", data_size + 4 + 2 * 8 + 16) + b"WAVE"
    fmt = b"fmt " + struct.pack(
        "<IHHIIHH", 16, fmt_tag, num_channels, sample_rate,
        sample_rate * block_align, block_align, bits_per_sample)
    data = b"data" + struct.pack("<I", data_size)
    return riff + fmt + data


def read_wav(blob: bytes):
    """Parse an integer-PCM or IEEE-float RIFF WAV file.

    Returns (pcm, sample_rate, bits_per_sample, header, trailer):
    pcm is (n, ch) int64 in the signed stored domain (8-bit content is
    offset to signed, matching WavpackFormatSamples' +128 un-offset,
    WavPackUtils.cs:300-307), or (n, ch) float32 for format-tag-3
    files (the dtype routes the encode path to FLOAT_DATA blocks);
    header is the raw prefix through the data chunk header and trailer
    the bytes after the payload -- both stored verbatim in the .wv
    (ID_RIFF_HEADER/_TRAILER) so decode reproduces the original file
    byte-exactly (WvDemo.cs:74-77,139-141).
    """
    if len(blob) < 12 or blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError("not a RIFF WAVE file")
    pos, fmt = 12, None
    while pos + 8 <= len(blob):
        cid = blob[pos:pos + 4]
        size = int.from_bytes(blob[pos + 4:pos + 8], "little")
        body = pos + 8
        if cid == b"fmt ":
            if size < 16 or body + 16 > len(blob):
                raise ValueError("truncated WAV fmt chunk")
            tag, ch, rate, _, balign, bits = struct.unpack(
                "<HHIIHH", blob[body:body + 16])
            if tag == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                tag = int.from_bytes(blob[body + 24:body + 26], "little")
            if tag not in (1, 3):
                raise ValueError(f"unsupported WAV format tag {tag}")
            if tag == 3 and bits != 32:
                raise ValueError(f"float WAV must be 32-bit, got {bits}")
            if balign and ch and balign != ((bits + 7) // 8) * ch:
                # inconsistent headers silently mis-frame the payload;
                # reject like any mainstream reader would
                raise ValueError(
                    f"WAV block align {balign} contradicts "
                    f"{bits}-bit x {ch}ch")
            fmt = (tag, ch, rate, bits)
        elif cid == b"data":
            if fmt is None:
                raise ValueError("WAV data chunk before fmt")
            tag, ch, rate, bits = fmt
            bps = (bits + 7) // 8
            if bps not in (1, 2, 3, 4):
                raise ValueError(f"unsupported bit depth {bits}")
            nbytes = min(size, len(blob) - body)
            n = nbytes // (bps * ch)
            v = decode_pcm_bytes(blob[body:body + n * bps * ch], bps,
                                 float_data=tag == 3)
            # trailer starts right after the payload: an odd-size pad
            # byte belongs to it so the decode-side rewrite stays
            # byte-exact
            end = body + size
            return (v.reshape(n, ch), rate, bits, blob[:body],
                    blob[end:] if end < len(blob) else None)
        pos = body + size + (size & 1)
    raise ValueError("WAV file has no data chunk")


def decode_pcm_bytes(buf: bytes, bps: int,
                     float_data: bool = False) -> np.ndarray:
    """Little-endian stored PCM bytes -> flat signed int64 samples
    (8-bit content is offset to signed, matching WavpackFormatSamples'
    +128 un-offset, WavPackUtils.cs:300-307). Chunk-safe: any slice on
    a sample boundary decodes independently. float_data=True reads
    IEEE float32 samples and returns float32 (the encode path's float
    grid derivation keeps the exact bits)."""
    if float_data:
        return np.frombuffer(buf, "<f4")
    raw = np.frombuffer(buf, np.uint8)
    raw = raw.reshape(len(raw) // bps, bps).astype(np.int64)
    v = np.zeros(raw.shape[0], np.int64)
    for k in range(bps):
        v |= raw[:, k] << (8 * k)
    if bps == 1:
        return v - 128  # u8 storage -> signed
    width = 8 * bps
    return (v ^ (1 << (width - 1))) - (1 << (width - 1))


def scan_wav_file(path):
    """Locate a WAV file's PCM payload without loading it.

    Returns (ch, rate, bits, data_offset, data_size, header, trailer,
    fmt_tag): `header` is the raw prefix through the data chunk header
    and `trailer` the bytes after the payload (both small; stored
    verbatim in the .wv like read_wav's); fmt_tag is 1 (integer PCM)
    or 3 (IEEE float32). The payload itself stays on disk -- the
    bounded-memory streaming encoder reads it in windows."""
    import os
    fsize = os.path.getsize(path)
    with open(path, "rb") as f:
        pre = f.read(12)
        if len(pre) < 12 or pre[:4] != b"RIFF" or pre[8:12] != b"WAVE":
            raise ValueError("not a RIFF WAVE file")
        pos, fmt, hdr = 12, None, bytearray(pre)
        while pos + 8 <= fsize:
            f.seek(pos)
            chead = f.read(8)
            if len(chead) < 8:
                break
            cid = chead[:4]
            size = int.from_bytes(chead[4:8], "little")
            body = pos + 8
            if cid == b"fmt ":
                if size < 16 or body + 16 > fsize:
                    raise ValueError("truncated WAV fmt chunk")
                cbody = f.read(min(size, 40))
                hdr += chead + cbody + f.read(
                    size + (size & 1) - len(cbody))
                tag, ch, rate, _, balign, bits = struct.unpack(
                    "<HHIIHH", cbody[:16])
                if tag == 0xFFFE and size >= 40:
                    tag = int.from_bytes(cbody[24:26], "little")
                if tag not in (1, 3):
                    raise ValueError(f"unsupported WAV format tag {tag}")
                if balign and ch and balign != ((bits + 7) // 8) * ch:
                    raise ValueError(
                        f"WAV block align {balign} contradicts "
                        f"{bits}-bit x {ch}ch")
                if tag == 3 and bits != 32:
                    raise ValueError(
                        f"float WAV must be 32-bit, got {bits}")
                fmt = (tag, ch, rate, bits)
            elif cid == b"data":
                if fmt is None:
                    raise ValueError("WAV data chunk before fmt")
                tag, ch, rate, bits = fmt
                bps = (bits + 7) // 8
                if bps not in (1, 2, 3, 4):
                    raise ValueError(f"unsupported bit depth {bits}")
                hdr += chead
                nbytes = min(size, fsize - body)
                nbytes -= nbytes % (bps * ch)
                # trailer anchored at body+size exactly like read_wav
                # (the odd-size pad byte lives there, so the
                # decode-side rewrite stays byte-exact)
                end = body + size
                trailer = None
                if end < fsize:
                    f.seek(end)
                    trailer = f.read()
                return (ch, rate, bits, body, nbytes, bytes(hdr), trailer,
                        tag)
            else:
                cbody = f.read(size + (size & 1))
                hdr += chead + cbody
            pos = body + size + (size & 1)
    raise ValueError("WAV file has no data chunk")


def write_wav(path, pcm_bytes: bytes, *, total_samples: int,
              num_channels: int, sample_rate: int, bits_per_sample: int,
              bytes_per_sample: int, header: bytes | None = None,
              trailer: bytes | None = None, fmt_tag: int = 1) -> None:
    """Write a WAV file; a saved RIFF header from the container is used
    verbatim when present (WvDemo.cs:74-77)."""
    with open(path, "wb") as f:
        f.write(header if header is not None else make_wav_header(
            total_samples, num_channels, sample_rate, bits_per_sample,
            bytes_per_sample, fmt_tag=fmt_tag))
        f.write(pcm_bytes)
        if trailer:
            f.write(trailer)
