"""Multichannel (>2ch) test-vector encoding.

WavPack stores multichannel audio as a segment of 1-2 channel streams per
time window: the first block carries INITIAL_BLOCK, the last FINAL_BLOCK
(Defines.cs:94,43), with ID_CHANNEL_INFO metadata declaring the total
channel count and WAVEFORMATEX mask (UnpackUtils.cs:389-410). Each stream
is an independent self-seeded encode.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from .. import consts
from ..container.header import HEADER_SIZE
from .encoder import CarryState, EncodeSpec, EncPass, _auto_medians, \
    _make_words_state, _stored_domain, encode_block, mkmeta


def split_streams(num_channels: int) -> list[int]:
    """Channel widths per stream: stereo pairs then a trailing mono."""
    widths = [2] * (num_channels // 2)
    if num_channels & 1:
        widths.append(1)
    return widths


def stream_specs(spec: EncodeSpec, nch: int) -> list[EncodeSpec]:
    """Per-stream specs for a >2ch segment (deterministic in `spec`, so
    every window of a streamed encode derives the same list)."""
    out = []
    for w in split_streams(nch):
        # block_checksum is stamped LAST in the assembler: the
        # segment-flag rewrite and channel-info injection both change
        # covered bytes, so a checksum from encode_block would be stale
        sspec = replace(spec, mono=(w == 1), false_stereo=False,
                        block_checksum=0)
        if w == 1 and any(t < 0 for t in sspec.terms):
            # cross-channel terms (-1/-2/-3) are stereo-only: the mono
            # decode path has no branch for them (UnpackUtils.cs:1156-1240
            # switches on 17/18/ring terms), so a conforming encoder never
            # emits them on a mono tail stream
            keep = [(t, d) for t, d in zip(sspec.terms, sspec.deltas)
                    if t > 0]
            if not keep:
                keep = [(2, 2)]
            sspec = replace(sspec, terms=tuple(t for t, _ in keep),
                            deltas=tuple(d for _, d in keep))
        out.append(sspec)
    return out


def encode_multichannel(pcm: np.ndarray, spec: EncodeSpec,
                        channel_mask: int | None = None, *,
                        start_sample: int = 0, first: bool = True,
                        last: bool = True, md5_digest: bytes | None = None,
                        carries: list[CarryState] | None = None,
                        return_carries: bool = False,
                        wvc_sink: list | None = None):
    """Encode (n, ch>2) PCM into segment-structured WavPack blocks.

    The keyword hooks position `pcm` as one window of a larger stream
    (see encoder.py::encode_blocks): `carries` threads each stream's
    adaptive state across windows, `first`/`last` gate the segment's
    file-level metadata (ID_CHANNEL_INFO + RIFF header / MD5 + trailer),
    and spec.total_samples_override carries the file total.
    """
    n, nch = pcm.shape
    assert nch > 2
    widths = split_streams(nch)
    if channel_mask is None:
        channel_mask = (1 << nch) - 1
    total = spec.total_samples_override
    if total is None:
        total = n

    # per-stream specs, windows and carries
    streams = []
    off = 0
    for si, (w, sspec) in enumerate(zip(widths, stream_specs(spec, nch))):
        sub = pcm[:, off:off + w]
        stored = _stored_domain(sub, sspec)
        if carries is not None:
            carry = carries[si]
        else:
            medians = sspec.initial_medians or _auto_medians(stored)
            carry = CarryState(
                passes=[EncPass(t, d)
                        for t, d in zip(sspec.terms, sspec.deltas)],
                words=_make_words_state(sspec, medians))
        streams.append((sspec, sub, stored, carry))
        off += w

    chan_info = bytes([nch]) + channel_mask.to_bytes(
        max(1, (channel_mask.bit_length() + 7) // 8), "little")

    digest = md5_digest
    if spec.md5 and last and digest is None:
        # digest covers the full interleaved output (all streams), stored
        # once in the file's final block like single-stream encode_blocks
        import hashlib

        from ..io.pcm import format_samples
        digest = hashlib.md5(format_samples(
            pcm, spec.bytes_stored)).digest()

    out = bytearray()
    bs = spec.block_samples
    first_seg = first
    for start in range(0, n, bs):
        end = min(start + bs, n)
        for si, (sspec, sub, stored, carry) in enumerate(streams):
            blk = encode_block(stored[start:end], sub[start:end], sspec,
                               carry, block_index=start_sample + start,
                               total_samples=total,
                               is_first=(first and start == 0 and si == 0),
                               is_last=(last and end >= n
                                        and si == len(streams) - 1),
                               md5_digest=digest if spec.md5 else None,
                               wvc_sink=wvc_sink)
            blk = _set_segment_flags(blk, initial=(si == 0),
                                     final=(si == len(streams) - 1))
            if wvc_sink is not None and sspec.wvc and sspec.hybrid:
                # the correction block's header mirrors the audio
                # block's, segment flags included
                wvc_sink[-1] = _set_segment_flags(
                    wvc_sink[-1], initial=(si == 0),
                    final=(si == len(streams) - 1))
                if spec.block_checksum:
                    from ..container.checksum import add_block_checksum
                    wvc_sink[-1] = add_block_checksum(
                        wvc_sink[-1], spec.block_checksum)
            if first_seg and si == 0:
                blk = _inject_metadata(
                    blk, mkmeta(consts.ID_CHANNEL_INFO, chan_info))
            if spec.block_checksum:
                from ..container.checksum import add_block_checksum
                blk = add_block_checksum(blk, spec.block_checksum)
            out += blk
        first_seg = False
    if return_carries:
        return bytes(out), [c for _, _, _, c in streams]
    return bytes(out)


def _set_segment_flags(block: bytes, initial: bool, final: bool) -> bytes:
    blk = bytearray(block)
    flags = int.from_bytes(blk[24:28], "little")
    flags &= ~(consts.INITIAL_BLOCK | consts.FINAL_BLOCK)
    if initial:
        flags |= consts.INITIAL_BLOCK
    if final:
        flags |= consts.FINAL_BLOCK
    blk[24:28] = flags.to_bytes(4, "little")
    return bytes(blk)


def _inject_metadata(block: bytes, meta: bytes) -> bytes:
    """Insert a metadata sub-block right after the header, growing ckSize."""
    blk = bytearray(block)
    ck = int.from_bytes(blk[4:8], "little") + len(meta)
    blk[4:8] = ck.to_bytes(4, "little")
    return bytes(blk[:HEADER_SIZE]) + meta + bytes(blk[HEADER_SIZE:])
