"""Per-block decode state from metadata (the reference's unpack_init L3).

Decodes the self-seeding block metadata into plain Python/numpy state:
decorrelation terms/weights/history (UnpackUtils.cs:156-360), entropy medians
and hybrid profile (WordsUtils.cs:75-187), float/int32 info
(FloatUtils.cs:15-30, UnpackUtils.cs:367-382), bitstream payloads
(UnpackUtils.cs:74-147) and DSD tables (DsdUtils.cs:17-54,149-242,321-389).

Because every WavPack block is self-seeded, this state is all a device lane
needs — it is what makes blocks the embarrassingly-parallel axis.

Frozen copy for the benchmark, taken from wvpk_torch/container/blockstate.py: the yardstick does not follow
later changes to the program, and imports nothing of it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import consts
from .tables import exp2s, i16, restore_weight
from .header import BlockHeader
from .metadata import MetadataItem

MAX_HISTORY_BITS = 5
MAX_BYTES_PER_BIN = 1280
MAX_DSD_BITS_VALUE = 256
PTABLE_BINS = 256
DSD_RATE_S = 20


class BlockStateError(ValueError):
    """Raised where the reference returns FALSE from a metadata reader."""


@dataclass
class DsdState:
    mode: int
    data: bytes            # remaining coded payload (after table/filter init)
    multiplier: int
    # fast (mode 1) tables
    history_bins: int = 0
    probabilities: np.ndarray | None = None         # (bins, 256) uint8
    summed_probabilities: np.ndarray | None = None  # (bins, 256) uint16
    value_lookup: np.ndarray | None = None          # (bins,) int32 offsets
    lookup_buffer: np.ndarray | None = None         # (total,) uint8
    # high (mode 3) state
    rate_i: int = 0
    ptable: np.ndarray | None = None                # (256,) int32
    filters: np.ndarray | None = None               # (2, 8) int32: f1..f6,factor,pad
    # shared range/arith coder init
    value: int = 0
    low: int = 0
    high: int = 0xFFFFFFFF


@dataclass
class BlockState:
    header: BlockHeader
    num_terms: int = 0
    terms: list[int] = field(default_factory=lambda: [0] * consts.MAX_NTERMS)
    deltas: list[int] = field(default_factory=lambda: [0] * consts.MAX_NTERMS)
    weights_a: list[int] = field(default_factory=lambda: [0] * consts.MAX_NTERMS)
    weights_b: list[int] = field(default_factory=lambda: [0] * consts.MAX_NTERMS)
    samples_a: np.ndarray = field(
        default_factory=lambda: np.zeros((consts.MAX_NTERMS, consts.MAX_TERM), np.int64))
    samples_b: np.ndarray = field(
        default_factory=lambda: np.zeros((consts.MAX_NTERMS, consts.MAX_TERM), np.int64))
    medians: list[list[int]] = field(default_factory=lambda: [[0, 0, 0], [0, 0, 0]])
    slow_level: list[int] = field(default_factory=lambda: [0, 0])
    bitrate_acc: list[int] = field(default_factory=lambda: [0, 0])
    bitrate_delta: list[int] = field(default_factory=lambda: [0, 0])
    float_flags: int = 0
    float_shift: int = 0
    float_max_exp: int = 0
    float_norm_exp: int = 0
    float_min_shifted_zeros: int = 0
    float_max_shifted_ones: int = 0
    int32_sent_bits: int = 0
    int32_zeros: int = 0
    int32_ones: int = 0
    int32_dups: int = 0
    int32_max_width: int = 0
    wvbits: bytes | None = None
    # correction bitstream (hybrid-lossless). The reference parses this
    # item (UnpackUtils.cs:93-108) but never decodes it; wvpk attaches
    # the payload from the paired .wvc file's block here (pair_wvc) and
    # decodes it — a beyond-parity surface. wvc_crc is the paired
    # correction block's header crc, which covers the EXACT samples.
    wvcbits: bytes | None = None
    wvc_crc: int | None = None
    wvxbits: bytes | None = None      # payload after the 4-byte crc_mvx
    wvx_start_bit: int = 0            # 5/10 for ID_WVX_NEW_BITSTREAM fields
    crc_mvx: int = 0
    dsd: DsdState | None = None

    @property
    def flags(self) -> int:
        return self.header.flags

    @property
    def is_mono_data(self) -> bool:
        return bool(self.flags & consts.MONO_DATA)


@dataclass
class ContextUpdates:
    """Block-level metadata that updates the file-level context."""
    num_channels: int | None = None
    channel_mask: int | None = None
    config_flags: int | None = None
    xmode: int | None = None
    sample_rate: int | None = None
    five: bool = False
    file_format: int | None = None
    file_extension: str | None = None
    riff_header: bytes | None = None
    riff_trailer: bytes | None = None
    dsd_multiplier: int | None = None
    # stored MD5 of the source audio (ID_MD5_CHECKSUM). The reference
    # ignores this sub-block entirely (MetadataUtils.cs:188-193
    # optional-data fallthrough, no `five` update); wvpk keeps that exact
    # decode behavior and additionally surfaces the digest through the
    # WavpackGetMD5Sum extension getter.
    md5: bytes | None = None


def _read_decorr_terms(st: BlockState, data: bytes) -> None:
    # terms stored reversed vs decode order (UnpackUtils.cs:156-187)
    termcnt = len(data)
    if termcnt > consts.MAX_NTERMS:
        raise BlockStateError("too many decorr terms")
    st.num_terms = termcnt
    for i, b in enumerate(data):
        dcounter = termcnt - 1 - i
        term = (b & 0x1F) - 5
        delta = (b >> 5) & 0x7
        if term < -3 or (consts.MAX_TERM < term < 17) or term > 18:
            raise BlockStateError(f"invalid decorr term {term}")
        st.terms[dcounter] = term
        st.deltas[dcounter] = delta


def _read_decorr_weights(st: BlockState, data: bytes, mono: bool) -> None:
    termcnt = len(data) if mono else len(data) // 2
    if termcnt > st.num_terms:
        raise BlockStateError("too many decorr weights")
    counter = 0
    idx = st.num_terms - 1
    for _ in range(termcnt):
        st.weights_a[idx] = i16(restore_weight(data[counter]))
        counter += 1
        if not mono:
            st.weights_b[idx] = i16(restore_weight(data[counter]))
            counter += 1
        idx -= 1


def _read_decorr_samples(st: BlockState, data: bytes, mono: bool,
                         version: int, hybrid: bool) -> None:
    counter = 0
    if version == 0x402 and hybrid:
        counter += 2 if mono else 4
    idx = st.num_terms - 1

    def rd16() -> int:
        nonlocal counter
        v = data[counter] | (data[counter + 1] << 8)
        counter += 2
        return exp2s(v - 0x10000 if v >= 0x8000 else v)

    while counter < len(data):
        if idx < 0:
            raise BlockStateError("decorr samples overflow terms")
        term = st.terms[idx]
        if term > consts.MAX_TERM:
            st.samples_a[idx][0] = rd16()
            st.samples_a[idx][1] = rd16()
            if not mono:
                st.samples_b[idx][0] = rd16()
                st.samples_b[idx][1] = rd16()
        elif term < 0:
            st.samples_a[idx][0] = rd16()
            st.samples_b[idx][0] = rd16()
        else:
            for m in range(term):
                st.samples_a[idx][m] = rd16()
                if not mono:
                    st.samples_b[idx][m] = rd16()
        idx -= 1


def _read_entropy_vars(st: BlockState, data: bytes, mono: bool) -> None:
    if len(data) != 12 and not mono:
        raise BlockStateError("entropy vars length")
    rd = lambda i: exp2s(data[i] | (data[i + 1] << 8))  # noqa: E731
    st.medians[0] = [rd(0), rd(2), rd(4)]
    if not mono:
        st.medians[1] = [rd(6), rd(8), rd(10)]


def _read_hybrid_profile(st: BlockState, data: bytes, mono: bool,
                         hybrid_bitrate: bool) -> None:
    c = 0

    def rd16u() -> int:
        nonlocal c
        v = data[c] | (data[c + 1] << 8)
        c += 2
        return v

    if hybrid_bitrate:
        st.slow_level[0] = exp2s(rd16u())
        if not mono:
            st.slow_level[1] = exp2s(rd16u())
    st.bitrate_acc[0] = rd16u() << 16
    if not mono:
        st.bitrate_acc[1] = rd16u() << 16
    if c < len(data):
        v = rd16u()
        st.bitrate_delta[0] = exp2s(v - 0x10000 if v >= 0x8000 else v)
        if not mono:
            v = rd16u()
            st.bitrate_delta[1] = exp2s(v - 0x10000 if v >= 0x8000 else v)
        if c < len(data):
            raise BlockStateError("hybrid profile too long")
    else:
        st.bitrate_delta[0] = st.bitrate_delta[1] = 0


def _read_float_info(st: BlockState, data: bytes) -> None:
    if len(data) != 4:
        raise BlockStateError("float info length")
    st.float_flags, st.float_shift, st.float_max_exp, st.float_norm_exp = data


def _read_int32_info(st: BlockState, data: bytes) -> None:
    if len(data) != 4:
        raise BlockStateError("int32 info length")
    st.int32_sent_bits, st.int32_zeros, st.int32_ones, st.int32_dups = data


def _init_wvx(st: BlockState, item: MetadataItem) -> None:
    data = item.data
    if len(data) <= 4 or (len(data) & 1):
        raise BlockStateError("invalid wvx bitstream")
    st.crc_mvx = int.from_bytes(data[:4], "little")
    if st.crc_mvx >= 0x80000000:
        st.crc_mvx -= 0x100000000
    st.wvxbits = data[4:]
    if item.id == consts.ID_WVX_NEW_BITSTREAM:
        # one or two leading 5-bit fields (UnpackUtils.cs:132-144)
        first = data[4] if len(data) > 4 else 0
        if st.flags & consts.FLOAT_DATA:
            st.float_min_shifted_zeros = first & 0x1F
            second = ((data[4] >> 5) | (data[5] << 3)) & 0x1F if len(data) > 5 else 0
            st.float_max_shifted_ones = second
            st.wvx_start_bit = 10
        else:
            st.int32_max_width = first & 0x1F
            st.wvx_start_bit = 5


def _init_dsd(st: BlockState, data: bytes, updates: ContextUpdates) -> None:
    if len(data) < 2:
        raise BlockStateError("invalid DSD block")
    # C#: dsd_multiplier = 1U << data[0] (DsdUtils.cs:34) — a uint shift,
    # mod-32, so a corrupt byte > 31 wraps instead of erroring
    multiplier = 1 << (data[0] & 31)
    updates.dsd_multiplier = multiplier
    mode = data[1]
    p = 2
    if mode == 0:
        chans = 1 if st.is_mono_data else 2
        if len(data) - p != st.header.block_samples * chans:
            raise BlockStateError("DSD raw payload size mismatch")
        st.dsd = DsdState(mode=0, data=data[p:], multiplier=multiplier)
    elif mode == 1:
        st.dsd = _init_dsd_fast(data, p, multiplier)
    elif mode == 3:
        st.dsd = _init_dsd_high(st, data, p, multiplier)
    else:
        raise BlockStateError(f"unsupported DSD mode {mode}")


def _init_dsd_fast(data: bytes, p: int, multiplier: int) -> DsdState:
    # RLE-coded probability tables + value-lookup expansion
    # (DsdUtils.cs:149-242)
    if p >= len(data):
        raise BlockStateError("DSD fast: truncated")
    history_bits = data[p]
    p += 1
    if p >= len(data) or history_bits > MAX_HISTORY_BITS:
        raise BlockStateError("DSD fast: bad history bits")
    bins = 1 << history_bits
    probabilities = np.zeros(bins * MAX_DSD_BITS_VALUE, np.uint8)
    max_probability = data[p]
    p += 1
    if max_probability < 0xFF:
        outptr = 0
        outend = probabilities.size
        while outptr < outend and p < len(data):
            code = data[p]
            p += 1
            if code > max_probability:
                zcount = code - max_probability
                outptr = min(outptr + zcount, outend)
            elif code != 0:
                probabilities[outptr] = code
                outptr += 1
            else:
                break
        if outptr < outend:
            raise BlockStateError("DSD fast: short probability table")
        if p < len(data):
            term = data[p]
            p += 1
            if term > 0:
                raise BlockStateError("DSD fast: bad table terminator")
    elif len(data) - p > probabilities.size:
        probabilities[:] = np.frombuffer(data[p:p + probabilities.size], np.uint8)
        p += probabilities.size
    else:
        raise BlockStateError("DSD fast: truncated raw table")

    prob2 = probabilities.reshape(bins, MAX_DSD_BITS_VALUE)
    summed = np.cumsum(prob2.astype(np.uint32), axis=1)
    if int(summed[:, -1].sum()) > bins * MAX_BYTES_PER_BIN:
        raise BlockStateError("DSD fast: summed probabilities overflow")
    value_lookup = np.zeros(bins, np.int32)
    chunks = []
    lb_ptr = 0
    for bi in range(bins):
        if summed[bi, -1] != 0:
            value_lookup[bi] = lb_ptr
            chunk = np.repeat(np.arange(MAX_DSD_BITS_VALUE, dtype=np.uint8), prob2[bi])
            chunks.append(chunk)
            lb_ptr += chunk.size
    lookup_buffer = (np.concatenate(chunks) if chunks
                     else np.zeros(0, np.uint8))
    if len(data) - p < 4:
        raise BlockStateError("DSD fast: missing initial value")
    value = int.from_bytes(data[p:p + 4], "big")
    p += 4
    return DsdState(mode=1, data=data[p:], multiplier=multiplier,
                    history_bins=bins, probabilities=prob2,
                    summed_probabilities=summed.astype(np.uint16),
                    value_lookup=value_lookup, lookup_buffer=lookup_buffer,
                    value=value)


def _init_ptable(rate_i: int, rate_s: int) -> np.ndarray:
    # DsdUtils.cs:321-341
    DOWN, DECAY = 0x00010000, 8
    table = np.zeros(PTABLE_BINS, np.int64)
    value = 0x808000
    rate = rate_i << 8
    for _ in range((rate + 128) >> 8):
        value += (DOWN - value) >> DECAY
    for i in range(PTABLE_BINS // 2):
        table[i] = value
        table[PTABLE_BINS - 1 - i] = 0x100FFFF - value
        if value > 0x010000:
            rate += (rate * rate_s + 128) >> 8
            for _ in range((rate + 64) >> 7):
                value += (DOWN - value) >> DECAY
    return table.astype(np.int32)


def _init_dsd_high(st: BlockState, data: bytes, p: int, multiplier: int) -> DsdState:
    # DsdUtils.cs:343-389
    mono = st.is_mono_data
    need = 13 if mono else 20
    if len(data) - p < need:
        raise BlockStateError("DSD high: truncated")
    rate_i, rate_s = data[p], data[p + 1]
    p += 2
    if rate_s != DSD_RATE_S:
        raise BlockStateError("DSD high: bad rate_s")
    ptable = _init_ptable(rate_i, rate_s)
    nch = 1 if mono else 2
    filters = np.zeros((2, 8), np.int32)
    PRECISION = 20
    for ch in range(nch):
        f = [data[p + i] << (PRECISION - 8) for i in range(5)]
        p += 5
        factor = data[p] | (data[p + 1] << 8)
        p += 2
        if factor >= 0x8000:
            factor -= 0x10000
        filters[ch, 0:5] = f
        filters[ch, 5] = 0          # filter6
        filters[ch, 6] = factor
    value = int.from_bytes(data[p:p + 4], "big")
    p += 4
    return DsdState(mode=3, data=data[p:], multiplier=multiplier,
                    rate_i=rate_i, ptable=ptable, filters=filters, value=value)


def state_from_native(hdr: BlockHeader, a: np.ndarray, data: bytes
                      ) -> tuple[BlockState, ContextUpdates]:
    """Rehydrate a BlockState from the native parser's flat int64 state
    array (wvpk_parse_block; layout in native/csrc/wvpk_host.c). The C
    parser covers exactly the PCM-block subset of decode_block_state —
    anything else returns the fallback status and never reaches here."""
    st = BlockState(header=hdr)
    st.samples_a = a[65:193].reshape(16, 8).copy()
    st.samples_b = a[193:321].reshape(16, 8).copy()
    v = a.tolist()   # one bulk conversion; scalar indexing of int64 is slow
    st.num_terms = v[0]
    st.terms = v[1:17]
    st.deltas = v[17:33]
    st.weights_a = v[33:49]
    st.weights_b = v[49:65]
    st.medians = [v[321:324], v[324:327]]
    st.slow_level = v[327:329]
    st.bitrate_acc = v[329:331]
    st.bitrate_delta = v[331:333]
    (st.float_flags, st.float_shift, st.float_max_exp, st.float_norm_exp,
     st.float_min_shifted_zeros, st.float_max_shifted_ones) = v[333:339]
    (st.int32_sent_bits, st.int32_zeros, st.int32_ones, st.int32_dups,
     st.int32_max_width) = v[339:344]
    st.crc_mvx = v[344]
    st.wvx_start_bit = v[345]
    if v[346]:
        st.wvbits = bytes(data[v[346]:v[346] + v[347]])
    if v[348]:
        st.wvcbits = bytes(data[v[348]:v[348] + v[349]])
    if v[350]:
        st.wvxbits = bytes(data[v[350]:v[350] + v[351]])
    return st, ContextUpdates(five=bool(v[352]))


def decode_block_state(hdr: BlockHeader, items: list[MetadataItem]
                       ) -> tuple[BlockState, ContextUpdates]:
    """process_metadata over all sub-blocks (MetadataUtils.cs:111-193)."""
    st = BlockState(header=hdr)
    up = ContextUpdates()
    mono = st.is_mono_data
    for item in items:
        mid, data = item.id, item.data
        if mid in (consts.ID_DUMMY, consts.ID_ENCODER_INFO,
                   consts.ID_SHAPING_WEIGHTS):
            continue
        elif mid == consts.ID_DECORR_TERMS:
            _read_decorr_terms(st, data)
        elif mid == consts.ID_DECORR_WEIGHTS:
            _read_decorr_weights(st, data, mono)
        elif mid == consts.ID_DECORR_SAMPLES:
            _read_decorr_samples(st, data, mono, hdr.version,
                                 bool(hdr.flags & consts.HYBRID_FLAG))
        elif mid == consts.ID_ENTROPY_VARS:
            _read_entropy_vars(st, data, mono)
        elif mid == consts.ID_HYBRID_PROFILE:
            _read_hybrid_profile(st, data, mono,
                                 bool(hdr.flags & consts.HYBRID_BITRATE))
        elif mid == consts.ID_FLOAT_INFO:
            _read_float_info(st, data)
        elif mid == consts.ID_INT32_INFO:
            _read_int32_info(st, data)
        elif mid == consts.ID_CHANNEL_INFO:
            if not data or len(data) > 5:
                raise BlockStateError("channel info length")
            up.num_channels = data[0]
            mask = 0
            for shift, b in enumerate(data[1:]):
                mask |= b << (8 * shift)
            up.channel_mask = mask
        elif mid == consts.ID_CONFIG_BLOCK:
            if len(data) >= 3:
                up.config_flags = (data[0] << 8) | (data[1] << 16) | (data[2] << 24)
            if len(data) >= 4 and up.config_flags is not None and \
                    up.config_flags & consts.CONFIG_EXTRA_MODE:
                up.xmode = data[3]
            if len(data) >= 5:
                up.five = True
        elif mid == consts.ID_NEW_CONFIG_BLOCK:
            up.five = True
            if len(data) >= 1:
                up.file_format = data[0]
        elif mid == consts.ID_SAMPLE_RATE:
            if len(data) == 3:
                up.sample_rate = int.from_bytes(data, "little")
        elif mid == consts.ID_WV_BITSTREAM:
            st.wvbits = data
        elif mid == consts.ID_WVC_BITSTREAM:
            if len(data) & 1:
                raise BlockStateError("odd wvc bitstream")
            st.wvcbits = data
        elif mid in (consts.ID_WVX_BITSTREAM, consts.ID_WVX_NEW_BITSTREAM):
            _init_wvx(st, item)
        elif mid == consts.ID_DSD_BLOCK:
            _init_dsd(st, data, up)
        elif mid in (consts.ID_RIFF_HEADER, consts.ID_ALT_HEADER):
            up.riff_header = data
        elif mid in (consts.ID_RIFF_TRAILER, consts.ID_ALT_TRAILER):
            up.riff_trailer = data
        elif mid == consts.ID_ALT_EXTENSION:
            up.file_extension = data.decode("utf-8", errors="replace")
        elif mid == consts.ID_BLOCK_CHECKSUM:
            up.five = True
        elif mid == consts.ID_MD5_CHECKSUM:
            # surfaced for the getter extension; decode semantics are
            # unchanged from the reference's optional-data skip
            if len(data) == 16:
                up.md5 = bytes(data)
        elif mid & consts.ID_OPTIONAL_DATA:
            continue
        else:
            raise BlockStateError(f"invalid metadata id {mid}")
    # the reference's "invalid WavPack file" check (UnpackUtils.cs:51-55)
    if hdr.block_samples:
        if hdr.flags & consts.DSD_FLAG:
            if st.dsd is None:
                raise BlockStateError("DSD block without DSD metadata")
        elif st.wvbits is None:
            raise BlockStateError("audio block without wv bitstream")
    return st, up
