"""Public API: WavpackContext-style open/unpack/getters/seek (port of
wvpk/api.py, decode side).

Name-for-name parity with the reference's L5 surface
(WavPackUtils.cs:36-594): `WavpackOpenFileInput`, `WavpackUnpackSamples`,
`WavpackFormatSamples`, the getter family, and SetTime/SetSample seek.
Pythonic method names are provided alongside the C#-style module functions.
The one difference from wvpk: `WavpackOpenFileInput` takes `device`
("cuda" by default, or "cpu") and every unpack decodes there through
wvpk_torch's engine. A `.wvc` correction file pairs as in wvpk
(`wvc_source=`, or OPEN_WVC for the `<path>c` sibling) and makes hybrid
blocks decode losslessly; a correction file the open cannot use is closed
again, and one the context keeps is closed by `close()`.

Unlike the reference (sample-serial, single stream), unpacking is served
from the batched device engine: blocks are decoded lane-parallel in device
batches and cached, and the whole-file block index built at open makes
seek O(1) (vs the reference's <= 25-step estimate search,
WavPackUtils.cs:521-594).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import consts
from .config import get_options
from .container import Block, parse_blocks
from .device import resolve
from .engine import DecodedBlock, decode_states
from .io.pcm import format_samples


@dataclass
class WavpackConfig:
    bits_per_sample: int = 0
    bytes_per_sample: int = 0
    num_channels: int = 0
    float_norm_exp: int = 0
    flags: int = 0
    sample_rate: int = 0
    channel_mask: int = 0
    xmode: int = 0


@dataclass
class WavpackContext:
    blocks: list[Block] = field(default_factory=list)
    config: WavpackConfig = field(default_factory=WavpackConfig)
    total_samples: int = -1
    crc_errors: int = 0
    mute_blocks: int = 0
    reduced_channels: int = 0
    lossy_blocks: bool = False
    error_message: str = ""
    five: bool = False
    file_format: int = consts.FORMAT_WAV
    file_extension: str | None = None
    header: bytes | None = None
    trailer: bytes | None = None
    dsd_multiplier: int = 0
    md5: bytes | None = None
    sample_index: int = 0
    open_flags: int = 0
    version: int = 0
    all_channels: bool = False
    streaming: bool = False
    device: torch.device | None = None     # where unpack decodes
    # hybrid-lossless (.wvc correction file) pairing state: number of
    # audio blocks that received a correction payload, and whether EVERY
    # hybrid audio block did (drives MODE_WVC/MODE_LOSSLESS)
    wvc_paired: int = 0
    wvc_all_paired: bool = False
    _wvc_reader: object = None   # streaming mode's open correction file
    _decoded: dict = field(default_factory=dict)   # segment idx -> np array
    _first_audio: int = 0
    # segments: (block_index, end_index, [block positions]) per multichannel
    # segment (single-element lists for 1-2ch files)
    _segments: list = field(default_factory=list)
    # cumulative end_index per segment, built once at open: makes
    # _find_segment an O(log n) searchsorted instead of the reference's
    # <= 25-step estimate search (WavPackUtils.cs:521-594)
    _seg_ends: np.ndarray | None = None

    # ------------------------------------------------------------------
    def _get_states(self, flat: list[int]):
        """Block states for the given block indices. In streaming mode a
        block whose metadata fails to parse is concealed (None -> zero
        fill + mute downstream), matching the CRC-failure concealment
        tier; the eager path drops such blocks at open already."""
        from .container.stream import BlockParseError

        states = []
        for i in flat:
            try:
                st = self.blocks[i].state
            except BlockParseError:
                states.append(None)
                continue
            if self.streaming:
                _update_lossy(self, st)
            states.append(st)
        return states

    def _ensure_decoded(self, seg_idx: int) -> np.ndarray:
        """Decode (and cache) the assembled samples of a segment; decodes a
        whole batch of upcoming segments lane-parallel. The cache holds at
        most `cache_segments` segments (insertion-order eviction), so
        sequential decode of an arbitrarily long file stays O(batch)."""
        if seg_idx not in self._decoded:
            batch = get_options().batch_blocks
            todo_segs = [s for s in range(seg_idx,
                                          min(seg_idx + batch,
                                              len(self._segments)))
                         if s not in self._decoded]
            flat: list[int] = []
            for s in todo_segs:
                blocks = self._segments[s][2]
                flat += blocks if self.all_channels else blocks[:1]
            states = self._get_states(flat)
            results = decode_states([st for st in states if st is not None],
                                    self.device)
            it = iter(results)
            full = []
            for i, st in zip(flat, states):
                if st is None:
                    hdr = _headers_of(self)[i]
                    ch = 1 if hdr.flags & consts.MONO_FLAG else 2
                    full.append(DecodedBlock(
                        samples=np.zeros((hdr.block_samples, ch), np.int32),
                        crc=-1, crc_x=-1, mute_error=True, crc_error=True))
                else:
                    full.append(next(it))
            for r in full:
                if r.crc_error:
                    self.crc_errors += 1
                if r.mute_error:
                    self.mute_blocks += 1
            pos = 0
            for s in todo_segs:
                nblk = (len(self._segments[s][2]) if self.all_channels else 1)
                parts = full[pos:pos + nblk]
                pos += nblk
                self._decoded[s] = (parts[0].samples if nblk == 1 else
                                    np.concatenate([p.samples for p in parts],
                                                   axis=1))
            cap = max(get_options().cache_segments, len(todo_segs))
            while len(self._decoded) > cap:
                oldest = next(iter(self._decoded))
                if oldest == seg_idx:
                    break
                del self._decoded[oldest]
        return self._decoded[seg_idx]

    def close(self) -> None:
        """Release the underlying file handles (streaming mode): the .wv
        file and the correction file's reader."""
        if self.streaming and hasattr(self.blocks, "close"):
            self.blocks.close()
        if self._wvc_reader is not None:
            self._wvc_reader.close()
            self._wvc_reader = None

    # -- getters (reference names in module functions below) ------------
    def get_mode(self) -> int:
        mode = 0
        if self.config.flags & consts.CONFIG_HYBRID_FLAG:
            mode |= consts.MODE_HYBRID
            if self.wvc_all_paired:
                # hybrid-lossless: a full correction pairing restores the
                # source exactly (libwavpack's MODE_WVC semantics)
                mode |= consts.MODE_WVC | consts.MODE_LOSSLESS
        elif not (self.config.flags & consts.CONFIG_LOSSY_MODE):
            mode |= consts.MODE_LOSSLESS
        if self.lossy_blocks:
            mode &= ~consts.MODE_LOSSLESS
        if self.config.flags & consts.CONFIG_FLOAT_DATA:
            mode |= consts.MODE_FLOAT
        if self.config.flags & consts.CONFIG_HIGH_FLAG:
            mode |= consts.MODE_HIGH
            if (self.config.flags & consts.CONFIG_VERY_HIGH_FLAG) \
                    or self.version < 0x405:
                mode |= consts.MODE_VERY_HIGH
        if self.config.flags & consts.CONFIG_FAST_FLAG:
            mode |= consts.MODE_FAST
        if self.config.flags & consts.CONFIG_EXTRA_MODE:
            mode |= consts.MODE_EXTRA | ((self.config.xmode << 12)
                                         & consts.MODE_XMODE)
        if self.dsd_multiplier > 0:
            mode |= consts.MODE_DSD
        if self.md5 is not None or (self.config.flags
                                    & consts.CONFIG_MD5_CHECKSUM):
            mode |= consts.MODE_MD5   # extension (see consts.MODE_MD5)
        return mode

    def get_compression_level(self) -> str | None:
        mode = self.get_mode()
        result = None
        if mode & consts.MODE_FAST:
            result = "Fast"
        elif mode & consts.MODE_VERY_HIGH:
            result = "Very High"
        elif mode & consts.MODE_HIGH:
            result = "High"
        if mode & consts.MODE_EXTRA:
            result = (result or "Default") + ", "
            result += f"Extra-{(mode & consts.MODE_XMODE) >> 12}"
        return result


def _read_source(source) -> bytes:
    if isinstance(source, (bytes, bytearray)):
        return bytes(source)
    if isinstance(source, (str,)) or hasattr(source, "__fspath__"):
        with open(source, "rb") as f:
            return f.read()
    if hasattr(source, "read"):
        return source.read()
    raise TypeError(f"cannot read wavpack source {type(source)}")


def _headers_of(wpc: WavpackContext):
    if wpc.streaming:
        return wpc.blocks.headers
    return [b.header for b in wpc.blocks]


def _apply_updates(wpc: WavpackContext, up) -> None:
    if up.num_channels is not None:
        wpc.config.num_channels = up.num_channels
        wpc.config.channel_mask = up.channel_mask or 0
    if up.config_flags is not None:
        wpc.config.flags = (wpc.config.flags & 0xFF) | up.config_flags
    if up.xmode is not None:
        wpc.config.xmode = up.xmode
    if up.sample_rate is not None:
        wpc.config.sample_rate = up.sample_rate
    if up.five:
        wpc.five = True
    if up.file_format is not None:
        wpc.file_format = up.file_format
    if up.file_extension is not None:
        wpc.file_extension = up.file_extension
    if up.riff_header is not None and wpc.header is None:
        wpc.header = up.riff_header
    if up.riff_trailer is not None:
        wpc.trailer = up.riff_trailer
    if up.dsd_multiplier is not None:
        wpc.dsd_multiplier = up.dsd_multiplier
    if up.md5 is not None:
        wpc.md5 = up.md5


def _update_lossy(wpc: WavpackContext, st) -> None:
    """Lossy-block conditions (UnpackUtils.cs:57-64)."""
    if not st.header.block_samples:
        return
    if (st.flags & consts.FLOAT_DATA) and wpc.config.float_norm_exp == 0:
        # expose the stream's float grid (ID_FLOAT_INFO) for the float
        # output formatter; the first float block's norm_exp stands for
        # the stream (wvpk-encoded files keep it constant)
        wpc.config.float_norm_exp = st.float_norm_exp
    if (st.flags & consts.INT32_DATA) and st.int32_sent_bits \
            and st.wvxbits is None:
        wpc.lossy_blocks = True
    if (st.flags & consts.FLOAT_DATA) and (
            st.float_flags & (consts.FLOAT_EXCEPTIONS
                              | consts.FLOAT_ZEROS_SENT
                              | consts.FLOAT_SHIFT_SENT
                              | consts.FLOAT_SHIFT_SAME)):
        wpc.lossy_blocks = True


def _pair_wvc_source(wpc: WavpackContext, wvc_source) -> None:
    """Attach a correction file's payloads to the open context. Never
    raises: a broken correction file degrades to plain hybrid decode. A
    file this function opens is closed again when pairing fails; in
    streaming mode a paired reader stays open until `close()`."""
    from .container.blocks import pair_wvc
    from .container.stream import WvcReader

    is_path = (isinstance(wvc_source, str)
               or hasattr(wvc_source, "__fspath__"))
    f = None
    try:
        if wpc.streaming:
            f = open(wvc_source, "rb") if is_path else wvc_source
            reader = WvcReader(f)
            wpc.wvc_paired = wpc.blocks.attach_wvc(reader)
            wpc._wvc_reader = reader
        else:
            wpc.wvc_paired = pair_wvc(wpc.blocks, _read_source(wvc_source))
        hybrid_audio = sum(
            1 for h in _headers_of(wpc)
            if h.block_samples > 0 and (h.flags & consts.HYBRID_FLAG))
        wpc.wvc_all_paired = (hybrid_audio > 0
                              and wpc.wvc_paired >= hybrid_audio)
    except Exception:  # boundary: a correction file is optional
        wpc.wvc_paired = 0
        wpc.wvc_all_paired = False
        if is_path and f is not None and wpc._wvc_reader is None:
            f.close()


def WavpackOpenFileInput(source, flags: int = 0,
                         streaming: bool | None = None, wvc_source=None,
                         device: str | torch.device = "cuda"
                         ) -> WavpackContext:
    """Open a .wv source (bytes / path / file-like); reference
    WavPackUtils.cs:36-120.

    `streaming=None` auto-selects: path sources at least
    `DecodeOptions.stream_threshold` bytes open in bounded-memory
    streaming mode (header index eager, per-block payload parse lazy +
    LRU, decoded-segment cache evicted at `cache_segments`); everything
    else parses eagerly. Pass True/False to force.

    `wvc_source` (bytes / path / file-like) pairs a hybrid-lossless
    correction file; OPEN_WVC in `flags` pairs the sibling `<path>c` file
    instead (libwavpack's convention). The reference notes it "will not
    handle correction files" (WavPackUtils.cs:31); a missing or corrupt
    correction file falls back to plain (lossy) hybrid decode.

    `device` is where unpacking decodes: "cuda" (the CUDA kernels) or
    "cpu" (their plain PyTorch versions). "cuda" without a usable GPU
    raises here."""
    import os

    wpc = WavpackContext()
    wpc.device = resolve(device)
    wpc.open_flags = flags
    is_path = isinstance(source, str) or hasattr(source, "__fspath__")
    if streaming is None:
        streaming = (is_path and os.path.getsize(source)
                     >= get_options().stream_threshold)
    try:
        if streaming:
            from .container.stream import LazyBlocks, scan_headers_file
            f = open(source, "rb") if is_path else source
            headers = scan_headers_file(f)
            wpc.blocks = LazyBlocks(
                f, headers,
                cache_blocks=get_options().batch_blocks * 4)
            wpc.streaming = True
        else:
            data = _read_source(source)
            wpc.blocks = parse_blocks(data)
    except Exception as e:  # container-level failure
        wpc.error_message = f"invalid WavPack file: {e}"
        return wpc

    headers = _headers_of(wpc)
    first = None
    for i, h in enumerate(headers):
        if h.block_samples > 0:
            first = i
            break
    if first is None:
        wpc.error_message = "not compatible with this version of WavPack file!"
        return wpc

    if wpc.streaming:
        # parse eagerly only the prefix up to the first audio block plus
        # the trailing zero-sample blocks (RIFF trailer etc. live there);
        # lossy-block flags accrue lazily as blocks decode, matching the
        # reference's per-block unpack_init timing (UnpackUtils.cs:57-64)
        from .container.stream import BlockParseError
        walk = list(range(first + 1))
        tail = len(headers) - 1
        while tail > first and headers[tail].block_samples == 0:
            walk.append(tail)
            tail -= 1
        for i in sorted(set(walk)):
            try:
                b = wpc.blocks[i]
            except BlockParseError:
                continue
            _apply_updates(wpc, b.updates)
            _update_lossy(wpc, b.state)
    else:
        for b in wpc.blocks:
            _apply_updates(wpc, b.updates)
            _update_lossy(wpc, b.state)

    wpc._first_audio = first
    hdr = headers[first]
    wpc.version = hdr.version
    if hdr.total_samples != 0xFFFFFFFF:
        wpc.total_samples = hdr.total_samples
    # group audio blocks into multichannel segments (INITIAL..FINAL)
    cur: list[int] = []
    for i, h in enumerate(headers):
        if h.block_samples == 0:
            continue
        if h.is_initial and cur:
            h0 = headers[cur[0]]
            wpc._segments.append((h0.block_index, h0.end_index, cur))
            cur = []
        cur.append(i)
        if h.is_final:
            h0 = headers[cur[0]]
            wpc._segments.append((h0.block_index, h0.end_index, cur))
            cur = []
    if cur:
        h0 = headers[cur[0]]
        wpc._segments.append((h0.block_index, h0.end_index, cur))
    ends = np.asarray([e for (_s, e, _b) in wpc._segments], np.int64)
    if len(ends) and (np.diff(ends) >= 0).all():
        wpc._seg_ends = ends
    wpc.all_channels = bool(flags & consts.OPEN_ALL_CHANNELS)
    st_flags = hdr.flags
    wpc.config.flags = (wpc.config.flags & ~0xFF) | (st_flags & 0xFF)
    wpc.config.bytes_per_sample = (st_flags & consts.BYTES_STORED) + 1
    wpc.config.bits_per_sample = (
        wpc.config.bytes_per_sample * 8
        - ((st_flags & consts.SHIFT_MASK) >> consts.SHIFT_LSB))
    if wpc.config.flags & consts.CONFIG_FLOAT_DATA:
        wpc.config.bytes_per_sample = 3
        wpc.config.bits_per_sample = 24
    if wpc.config.sample_rate == 0:
        if (st_flags & consts.SRATE_MASK) == consts.SRATE_MASK:
            wpc.config.sample_rate = 44100
        else:
            wpc.config.sample_rate = consts.SAMPLE_RATES[
                (st_flags & consts.SRATE_MASK) >> consts.SRATE_LSB]
    if wpc.config.num_channels == 0:
        wpc.config.num_channels = 1 if st_flags & consts.MONO_FLAG else 2
        wpc.config.channel_mask = 0x5 - wpc.config.num_channels
    if (flags & consts.OPEN_2CH_MAX) and not (st_flags & consts.FINAL_BLOCK):
        wpc.reduced_channels = 1 if st_flags & consts.MONO_FLAG else 2
    if not (flags & (consts.OPEN_2CH_MAX | consts.OPEN_ALL_CHANNELS)) \
            and wpc.config.num_channels > 2:
        wpc.error_message = "only two channels supported!"
        return wpc
    if st_flags & consts.DSD_FLAG:
        wpc.config.bytes_per_sample = 1
        wpc.config.bits_per_sample = 8
    wpc.sample_index = headers[first].block_index
    # paired last, so that no failed open above leaves it open
    if wvc_source is None and (flags & consts.OPEN_WVC) and is_path:
        cand = os.fspath(source) + "c"
        if os.path.exists(cand):
            wvc_source = cand
    if wvc_source is not None:
        _pair_wvc_source(wpc, wvc_source)
    return wpc


def WavpackUnpackSamples(wpc: WavpackContext, buffer: np.ndarray,
                         samples: int) -> int:
    """Unpack `samples` complete samples into `buffer` (int32, interleaved);
    returns the count actually unpacked (WavPackUtils.cs:200-282)."""
    if wpc.all_channels:
        nch = wpc.config.num_channels
    else:
        nch = min(wpc.reduced_channels or wpc.config.num_channels, 2)
    unpacked = 0
    out_pos = 0
    while samples > 0:
        seg = _find_segment(wpc, wpc.sample_index)
        if seg is None:
            break
        start, end, _ = wpc._segments[seg]
        if wpc.sample_index < start:
            fill = min(start - wpc.sample_index, samples)
            buffer[out_pos:out_pos + fill * nch] = 0
            out_pos += fill * nch
            wpc.sample_index += fill
            unpacked += fill
            samples -= fill
            continue
        vals = wpc._ensure_decoded(seg)
        off = wpc.sample_index - start
        take = min(end - wpc.sample_index, samples)
        chunk = vals[off:off + take, :nch].reshape(-1)
        buffer[out_pos:out_pos + chunk.size] = chunk
        out_pos += chunk.size
        wpc.sample_index += take
        unpacked += take
        samples -= take
        if wpc.total_samples >= 0 and wpc.sample_index >= wpc.total_samples:
            break
    return unpacked


def _find_segment(wpc: WavpackContext, sample: int):
    """First segment whose end_index exceeds `sample`: O(log n) via the
    cumulative-end array built at open (falls back to a linear walk for
    malformed files with non-monotonic block indices)."""
    if wpc._seg_ends is not None:
        s = int(np.searchsorted(wpc._seg_ends, sample, side="right"))
        return s if s < len(wpc._segments) else None
    for s, (_start, end, _blocks) in enumerate(wpc._segments):
        if sample < end:
            return s
    return None


def WavpackFormatSamples(src: np.ndarray, samcnt: int, bps: int,
                         dsd: bool = False,
                         float_norm_exp: int | None = None) -> bytes:
    """Reformat int32 samples to little-endian PCM bytes
    (WavPackUtils.cs:288-341). float_norm_exp (extension): emit IEEE
    float32 bytes on the stream's FLOAT_DATA grid instead — see
    io/pcm.py; pass WavpackGetFloatNormExp(wpc) for float streams."""
    return format_samples(np.asarray(src).reshape(-1)[:samcnt], bps, dsd,
                          float_norm_exp=float_norm_exp)


# -- getter family ----------------------------------------------------------

def WavpackGetMode(wpc):
    return wpc.get_mode()


def WavpackGetCompressionLevel(wpc):
    return wpc.get_compression_level()


def WavpackGetNumSamples(wpc, native: bool = False):
    if native and wpc.dsd_multiplier > 0 and wpc.total_samples >= 0:
        return wpc.total_samples * 8
    return wpc.total_samples


def WavpackGetSampleIndex(wpc):
    return wpc.sample_index


def WavpackGetNumErrors(wpc):
    return wpc.crc_errors


def WavpackLossy(wpc):
    if wpc.wvc_all_paired and not wpc.lossy_blocks:
        return False   # hybrid-lossless: corrections restore the source
    return wpc.lossy_blocks or bool(wpc.config.flags
                                    & consts.CONFIG_HYBRID_FLAG)


def WavpackGetSampleRate(wpc):
    if wpc.config.sample_rate:
        if wpc.dsd_multiplier > 0:
            return wpc.dsd_multiplier * wpc.config.sample_rate * 8
        return wpc.config.sample_rate
    return 44100


def WavpackGetNumChannels(wpc):
    return wpc.config.num_channels or 2


def WavpackGetBitsPerSample(wpc):
    if wpc.config.bits_per_sample:
        if wpc.dsd_multiplier > 0:
            return wpc.config.bits_per_sample // 8
        return wpc.config.bits_per_sample
    return 16


def WavpackGetBytesPerSample(wpc):
    return wpc.config.bytes_per_sample or 2


def WavpackGetReducedChannels(wpc):
    return wpc.reduced_channels or wpc.config.num_channels or 2


def WavpackGetFileFormat(wpc):
    """File format enum (reference eFileFormat, WavPackUtils.cs:452-462)."""
    return consts.FileFormat(wpc.file_format)


def WavpackGetFileExtension(wpc):
    return wpc.file_extension or "wav"


def WavpackGetErrorMessage(wpc):
    return wpc.error_message


def WavpackGetHeader(wpc):
    return wpc.header


def WavpackGetTrailer(wpc):
    return wpc.trailer


def WavpackGetIsFive(wpc):
    return wpc.five


def WavpackGetVersion(wpc):
    return wpc.version


def WavpackGetIsFloat(wpc):
    return bool(wpc.config.flags & consts.CONFIG_FLOAT_DATA)


def WavpackGetFloatNormExp(wpc):
    """FLOAT_DATA streams' grid exponent (ID_FLOAT_INFO norm_exp of the
    first float block; 0 for integer streams). EXTENSION: feeds the
    float output formatter f = v * 2**(norm_exp - 150) — the reference
    demo has no float output path (it writes clipped ints,
    FloatUtils.cs:32-56 + WvDemo.cs:80-104)."""
    return wpc.config.float_norm_exp


def WavpackGetMD5Sum(wpc) -> bytes | None:
    """Stored MD5 of the source audio (ID_MD5_CHECKSUM sub-block), or
    None when the file carries none.

    EXTENSION beyond the C# reference, which skips the sub-block via the
    optional-data fallthrough (MetadataUtils.cs:188-193); mirrors
    libwavpack's getter of the same name. Writers store the digest in
    the file's final block, so streaming mode parses that block lazily
    on first call (eager mode saw it at open)."""
    if wpc.md5 is None and wpc.streaming and len(wpc.blocks):
        from .container.stream import BlockParseError
        try:
            b = wpc.blocks[len(wpc.blocks) - 1]
        except BlockParseError:
            return None
        if b.updates.md5 is not None:
            wpc.md5 = b.updates.md5
    return wpc.md5


def WavpackVerifyBlockChecksums(source) -> tuple[int, int, int]:
    """Audit every block's stored ID_BLOCK_CHECKSUM in a .wv source
    (bytes / path / file-like): returns (ok, bad, absent) counts.

    EXTENSION beyond the C# reference, which reads the item only to set
    the WavPack-5 flag (MetadataUtils.cs:184-186). Takes a source rather
    than an open context because decode never retains raw block bytes;
    path sources are memory-mapped (container/checksum.py)."""
    import os

    from .container import verify_file_checksums
    if hasattr(source, "__fspath__"):
        source = os.fspath(source)
    if isinstance(source, (str, bytes, bytearray)):
        return verify_file_checksums(source)
    return verify_file_checksums(_read_source(source))


# -- seek -------------------------------------------------------------------

def SetSample(wpc: WavpackContext, sample: int) -> bool:
    """O(1) seek via the block index (reference iterates header estimates,
    WavPackUtils.cs:504-594)."""
    if wpc.total_samples >= 0 and sample >= wpc.total_samples:
        return False
    sample = max(0, sample)
    if _find_segment(wpc, sample) is None:
        return False
    wpc.sample_index = sample
    return True


def SetTime(wpc: WavpackContext, milliseconds: int) -> bool:
    return SetSample(wpc, milliseconds // 1000 * wpc.config.sample_rate)
