"""Minimal WavPack encoder for self-generated test vectors.

Implements the exact inverse of the decode semantics in wvpk.ref.oracle:
decorrelation runs in reconstruction-feedback form (so hybrid/lossy blocks
stay bit-consistent with the decoder), the entropy coder mirrors
get_words' unary/holding/zero-run state machine (reference
WordsUtils.cs:272-511) including the one-word lookahead that the
holding_one/holding_zero carry implies, and block CRCs are stamped by
oracle-decoding the assembled block (the decoder's own CRC recurrence is
then an end-to-end check, not a shared code path).

Lossless modes must roundtrip PCM -> .wv -> PCM as the identity; that makes
this encoder an oracle independent of any decoder implementation.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np

from .. import consts
from ..container.header import HEADER_SIZE
from ..tables import count_bits, exp2s, i16, i32, log2s, mylog2, restore_weight, store_weight
from ..ref.oracle import (EntropyChannel, WordsState, median_interval,
                          update_error_limit)
from .bits import BitWriter


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------

@dataclass
class EncodeSpec:
    block_samples: int = 4096
    mono: bool = False
    false_stereo: bool = False
    joint: bool = False
    terms: tuple = (18, 17, 2)      # in decode order (pass 0 first)
    deltas: tuple = (2, 2, 2)
    bytes_stored: int = 2           # 1..4
    shift: int = 0
    sample_rate: int = 44100
    hybrid: bool = False
    hybrid_bitrate: bool = False
    hybrid_balance: bool = False
    bitrate: int = 512              # initial bitrate_acc >> 16
    bitrate_delta: int = 0
    int32_mode: str | None = None   # None | 'wvx' | 'zeros' | 'ones' | 'dups'
    int32_sent_bits: int = 0
    int32_zeros: int = 0
    int32_ones: int = 0
    int32_dups: int = 0
    int32_max_width: int = 0
    float_data: bool = False
    float_flags: int = 0
    float_shift: int = 0
    float_max_exp: int = 0
    float_norm_exp: int = 0
    version: int = 0x410
    initial_medians: tuple | None = None   # per-channel (m0, m1, m2)
    riff_header: bytes | None = None
    riff_trailer: bytes | None = None
    total_samples_override: int | None = None
    # emit ID_MD5_CHECKSUM in the final block: the MD5 of the decoded
    # audio's PCM byte image (format_samples layout). The C# reference
    # ignores this sub-block (MetadataUtils.cs:188-193 optional-data
    # fallthrough); real WavPack writers store it for integrity checks,
    # which wvpk's WavpackGetMD5Sum / --verify-md5 extension consumes.
    # Only meaningful for lossless specs (lossy decode != input).
    md5: bool = False
    # emit a trailing ID_BLOCK_CHECKSUM item (width 2 or 4, 0 = off) on
    # every block. The C# reference parses the item only to set `five`
    # (MetadataUtils.cs:184-186); wvpk's container/checksum.py audit
    # extension verifies it (CLI --verify-checksums).
    block_checksum: int = 0
    # informational CONFIG_* bits stamped as ID_CONFIG_BLOCK in the
    # first block (read at UnpackUtils.cs:432-455; WavpackGetMode
    # reports them). The lossy-float path sets CONFIG_LOSSY_MODE so
    # quantized streams never claim MODE_LOSSLESS.
    config_flags: int = 0
    # float32 content off any lossless FLOAT_DATA grid: quantize to the
    # nearest grid point instead of raising (opt-in; see
    # wvpk/encode.py's float grid note)
    float_lossy: bool = False
    # hybrid-lossless: emit a parallel "wvc" correction block per audio
    # block. The main stream stays a normal hybrid (lossy) stream; the
    # correction block carries, per coded word, the minimal-binary code
    # of (value - low) over the error_limit-narrowed interval, which
    # restores the exact residual. The reference PARSES the wvc
    # bitstream (UnpackUtils.cs:93-108) but never decodes it (readme
    # "Correction files are not handled") — this is a beyond-parity
    # surface matching libwavpack's hybrid-lossless semantics. Requires
    # hybrid=True; incompatible with wvx sent-bits routing (real WavPack
    # sends those bits inside the wvc file) and with the intra-sample
    # cross terms -1/-2 (see encode_blocks' chain check).
    wvc: bool = False

    @property
    def nch_data(self) -> int:
        return 1 if (self.mono or self.false_stereo) else 2

    def flags(self) -> int:
        f = self.bytes_stored - 1
        if self.mono:
            f |= consts.MONO_FLAG
        if self.false_stereo:
            f |= consts.FALSE_STEREO
        if self.joint and not self.mono and not self.false_stereo:
            f |= consts.JOINT_STEREO
        if self.hybrid:
            f |= consts.HYBRID_FLAG
        if self.hybrid_bitrate:
            f |= consts.HYBRID_BITRATE
        if self.hybrid_balance:
            f |= consts.HYBRID_BALANCE
        if self.float_data:
            f |= consts.FLOAT_DATA
        if self.int32_mode is not None:
            f |= consts.INT32_DATA
        f |= (self.shift & 0x1F) << consts.SHIFT_LSB
        try:
            srate_idx = consts.SAMPLE_RATES.index(self.sample_rate)
        except ValueError:
            srate_idx = 0xF
        f |= srate_idx << consts.SRATE_LSB
        return f


# ---------------------------------------------------------------------------
# decorrelation, encode direction
# ---------------------------------------------------------------------------

class EncPass:
    __slots__ = ("term", "delta", "wa", "wb", "sa", "sb", "m")

    def __init__(self, term: int, delta: int):
        self.term = term
        self.delta = delta
        self.wa = 0
        self.wb = 0
        self.sa = [0] * consts.MAX_TERM
        self.sb = [0] * consts.MAX_TERM
        self.m = 0

    def clone(self) -> "EncPass":
        p = EncPass(self.term, self.delta)
        p.wa, p.wb, p.m = self.wa, self.wb, self.m
        p.sa, p.sb = list(self.sa), list(self.sb)
        return p


def _pred(w: int, sam: int) -> int:
    return (w * sam + 512) >> 10


def _upd(w: int, delta: int, sam: int, v: int) -> int:
    if sam != 0 and v != 0:
        w += delta if (sam ^ v) >= 0 else -delta
    return w


def _upd_clamp(w: int, delta: int, sam: int, v: int) -> int:
    if (sam ^ v) < 0:
        if sam != 0 and v != 0:
            w -= delta
            if w < -1024:
                w = -1024 if w < 0 else 1024
    else:
        if sam != 0 and v != 0:
            w += delta
            if w > 1024:
                w = -1024 if w < 0 else 1024
    return w


def _sams(p: EncPass, va: int, vb: int) -> tuple[int, int]:
    """Predictor input values at this pass level, given the pass OUTPUT
    values (va, vb) of the current sample (needed by terms -1/-2)."""
    t = p.term
    if t == 17:
        return i32(2 * p.sa[0] - p.sa[1]), i32(2 * p.sb[0] - p.sb[1])
    if t == 18:
        return (i32((3 * p.sa[0] - p.sa[1]) >> 1),
                i32((3 * p.sb[0] - p.sb[1]) >> 1))
    if t == -1:
        return p.sa[0], va
    if t == -2:
        return vb, p.sb[0]
    if t == -3:
        return p.sa[0], p.sb[0]
    m_slot = p.m & (consts.MAX_TERM - 1)
    return p.sa[m_slot], p.sb[m_slot]


def invert_stereo(passes: list[EncPass], xa: int, xb: int) -> tuple[int, int]:
    """Peel all passes off a target output pair -> entropy residual pair.
    Pure (no state mutation)."""
    va, vb = xa, xb
    for p in reversed(passes):
        sam_a, sam_b = _sams(p, va, vb)
        va = i32(va - _pred(p.wa, sam_a))
        vb = i32(vb - _pred(p.wb, sam_b))
    return va, vb


def reconstruct_stereo(passes: list[EncPass], ra: int, rb: int) -> tuple[int, int]:
    """Decoder-identical chained pass application; mutates pass state."""
    va, vb = ra, rb
    for p in passes:
        t = p.term
        if t in (17, 18):
            sam_a, sam_b = _sams(p, 0, 0)
            oa = i32(_pred(p.wa, sam_a) + va)
            p.wa = _upd(p.wa, p.delta, sam_a, va)
            ob = i32(_pred(p.wb, sam_b) + vb)
            p.wb = _upd(p.wb, p.delta, sam_b, vb)
            p.sa[1], p.sa[0] = p.sa[0], oa
            p.sb[1], p.sb[0] = p.sb[0], ob
        elif t == -1:
            oa = i32(_pred(p.wa, p.sa[0]) + va)
            p.wa = _upd_clamp(p.wa, p.delta, p.sa[0], va)
            ob = i32(_pred(p.wb, oa) + vb)
            p.wb = _upd_clamp(p.wb, p.delta, oa, vb)
            p.sa[0] = ob
        elif t == -2:
            ob = i32(_pred(p.wb, p.sb[0]) + vb)
            p.wb = _upd_clamp(p.wb, p.delta, p.sb[0], vb)
            oa = i32(_pred(p.wa, ob) + va)
            p.wa = _upd_clamp(p.wa, p.delta, ob, va)
            p.sb[0] = oa
        elif t == -3:
            oa = i32(_pred(p.wa, p.sa[0]) + va)
            p.wa = _upd_clamp(p.wa, p.delta, p.sa[0], va)
            ob = i32(_pred(p.wb, p.sb[0]) + vb)
            p.wb = _upd_clamp(p.wb, p.delta, p.sb[0], vb)
            p.sb[0] = oa
            p.sa[0] = ob
        else:
            m_slot = p.m & (consts.MAX_TERM - 1)
            k_slot = (p.m + t) & (consts.MAX_TERM - 1)
            sam_a, sam_b = p.sa[m_slot], p.sb[m_slot]
            oa = i32(_pred(p.wa, sam_a) + va)
            p.wa = _upd(p.wa, p.delta, sam_a, va)
            p.sa[k_slot] = oa
            ob = i32(_pred(p.wb, sam_b) + vb)
            p.wb = _upd(p.wb, p.delta, sam_b, vb)
            p.sb[k_slot] = ob
        va, vb = oa, ob
    for p in passes:
        if 1 <= p.term <= consts.MAX_TERM:
            p.m += 1
    return va, vb


def invert_mono(passes: list[EncPass], xa: int) -> int:
    va = xa
    for p in reversed(passes):
        sam_a, _ = _sams(p, va, 0)
        va = i32(va - _pred(p.wa, sam_a))
    return va


def reconstruct_mono(passes: list[EncPass], ra: int) -> int:
    va = ra
    for p in passes:
        t = p.term
        if t in (17, 18):
            sam_a, _ = _sams(p, 0, 0)
            oa = i32(_pred(p.wa, sam_a) + va)
            p.wa = _upd(p.wa, p.delta, sam_a, va)
            p.sa[1], p.sa[0] = p.sa[0], oa
        else:
            m_slot = p.m & (consts.MAX_TERM - 1)
            k_slot = (p.m + t) & (consts.MAX_TERM - 1)
            sam_a = p.sa[m_slot]
            oa = i32(_pred(p.wa, sam_a) + va)
            p.wa = _upd(p.wa, p.delta, sam_a, va)
            p.sa[k_slot] = oa
        va = oa
    for p in passes:
        if 1 <= p.term <= consts.MAX_TERM:
            p.m += 1
    return va


def _rotate_ring(p: EncPass, n_samples: int) -> None:
    """End-of-block ring normalization for terms 1..8
    (reference UnpackUtils.cs:920-936)."""
    if not (1 <= p.term <= consts.MAX_TERM):
        p.m = 0
        return
    m = p.m & (consts.MAX_TERM - 1)
    if m:
        p.sa = [p.sa[(m + k) & 7] for k in range(8)]
        p.sb = [p.sb[(m + k) & 7] for k in range(8)]
    p.m = 0


# ---------------------------------------------------------------------------
# entropy encoder (inverse of get_words)
# ---------------------------------------------------------------------------

class EntropyEncoder:
    """Word-at-a-time encoder mirroring the decoder state machine.

    Bits for a word's unary part depend on the NEXT word's ones_count (the
    holding carry), so each word's bit output is deferred one word.
    """

    def __init__(self, flags: int, w: WordsState, bw: BitWriter,
                 cw: BitWriter | None = None):
        self.flags = flags
        self.mono = bool(flags & consts.MONO_DATA)
        self.w = w
        self.bw = bw
        # hybrid-lossless correction stream (the wvc block's payload):
        # gets one minimal-binary code per error_limit-quantized word,
        # in sample order — no unary/holding machinery of its own.
        self.cw = cw
        self.csamples = 0
        self.clear = True              # holding_one == holding_zero == False
        self._pend_oc_eff: int | None = None
        self._pend_bits: list[tuple[int, int]] = []
        self._pend_h1: bool = False

    # -- deferred emission ---------------------------------------------------
    def _flush(self, b: int) -> None:
        if self._pend_oc_eff is None:
            return
        raw = 2 * self._pend_oc_eff + b
        if raw < consts.LIMIT_ONES:
            self.bw.put_unary_ones(raw)
        else:
            self.bw.put_unary_ones(consts.LIMIT_ONES)
            self.bw.put_gamma(raw - consts.LIMIT_ONES)
        for val, n in self._pend_bits:
            self.bw.putbits(val, n)
        self._pend_oc_eff = None
        self._pend_bits = []

    def finish(self) -> None:
        self._flush(0)

    @staticmethod
    def _write_code(bw: BitWriter, code: int, maxcode: int) -> None:
        """Minimal binary code, the write mirror of the decoder's
        read_code (WordsUtils.cs:546-570)."""
        bitcount = count_bits(maxcode)
        if bitcount == 0:
            return
        extras = (1 << bitcount) - maxcode - 1
        if code < extras:
            bw.putbits(code, bitcount - 1)
        else:
            cc = code + extras
            bw.putbits(cc >> 1, bitcount - 1)
            bw.putbits(cc & 1, 1)

    # -- zero-run helpers ----------------------------------------------------
    def _medians_tiny(self) -> bool:
        return ((self.w.c[0].median[0] & ~1) == 0
                and (self.w.c[1].median[0] & ~1) == 0)

    def run_active_or_startable(self) -> bool:
        return self.clear and self._medians_tiny()

    # -- main entry ------------------------------------------------------
    def encode_word(self, r: int, zero_run_len=None) -> int:
        """Encode residual r; returns the decoded (reconstructed) residual.

        zero_run_len: callable() -> int giving the number of consecutive
        zero residuals starting at this word; only consulted when a zero-run
        escape could start here.
        """
        w = self.w
        entidx = 0 if self.mono else (self.csamples & 1)
        c = w.c[entidx]

        if self.clear and self._medians_tiny():
            if w.zeros_acc > 0:
                w.zeros_acc -= 1
                if w.zeros_acc > 0:
                    assert r == 0
                    c.slow_level -= (c.slow_level + consts.SLO) >> consts.SLS
                    self.csamples += 1
                    return 0
                # fell through: code this word normally
            else:
                z = zero_run_len() if zero_run_len is not None else (1 if r == 0 else 0)
                # previous word must have been h0-consumed or block start,
                # so nothing is pending
                assert self._pend_oc_eff is None
                self.bw.put_gamma(z)
                if z > 0:
                    w.zeros_acc = z
                    c.slow_level -= (c.slow_level + consts.SLO) >> consts.SLS
                    for ch in (0, 1):
                        w.c[ch].median[0] = 0
                        w.c[ch].median[1] = 0
                        w.c[ch].median[2] = 0
                    assert r == 0
                    self.csamples += 1
                    return 0

        sign = 1 if r < 0 else 0
        av = ~r if r < 0 else r

        # determine ones_count from pre-update medians
        g0 = (c.median[0] >> 4) + 1
        g1 = (c.median[1] >> 4) + 1
        g2 = (c.median[2] >> 4) + 1
        if av < g0:
            oc = 0
        elif av < g0 + g1:
            oc = 1
        else:
            oc = 2 + (av - g0 - g1) // g2

        # resolve holding: previous word's b = (oc >= 1)
        if self.clear:
            h1_old = False
            emit_unary = True
            self.clear = False
        else:
            if oc == 0:
                # h0-consumption: previous b = 0, this word has no unary
                self._flush(0)
                h1_old = False
                emit_unary = False
                self.clear = True
            else:
                self._flush(1)
                h1_old = True
                emit_unary = True

        bits: list[tuple[int, int]] = []

        if (self.flags & consts.HYBRID_FLAG) and \
                (self.mono or (self.csamples & 1) == 0):
            update_error_limit(w, self.flags)

        low, high = median_interval(c, oc)

        if c.error_limit == 0:
            # read_code inverse
            code = av - low
            maxcode = high - low
            bitcount = count_bits(maxcode)
            if bitcount:
                extras = (1 << bitcount) - maxcode - 1
                if code < extras:
                    bits.append((code, bitcount - 1))
                else:
                    cc = code + extras
                    bits.append((cc >> 1, bitcount - 1))
                    bits.append((cc & 1, 1))
            mid = av
        else:
            mid = (high + low + 1) >> 1
            while high - low > c.error_limit:
                if av >= mid:
                    bits.append((1, 1))
                    low = mid
                else:
                    bits.append((0, 1))
                    high = mid - 1
                mid = (high + low + 1) >> 1
            if self.cw is not None:
                # hybrid-lossless correction: code (av - low) over the
                # NARROWED interval (high - low <= error_limit) into the
                # wvc stream — the bits the binary search stopped short
                # of. Decode mirrors with read_code(wvcbits, high - low)
                # after its own (identical) narrowing loop.
                self._write_code(self.cw, av - low, high - low)

        bits.append((sign, 1))

        if emit_unary:
            self._pend_oc_eff = oc - (1 if h1_old else 0)
            self._pend_bits = bits
        else:
            for val, n in bits:
                self.bw.putbits(val, n)

        if self.flags & consts.HYBRID_BITRATE:
            c.slow_level = (c.slow_level
                            - ((c.slow_level + consts.SLO) >> consts.SLS)
                            + mylog2(mid))

        self.csamples += 1
        return i32(~mid) if sign else i32(mid)


# ---------------------------------------------------------------------------
# metadata assembly
# ---------------------------------------------------------------------------

def mkmeta(mid: int, payload: bytes) -> bytes:
    if len(payload) & 1:
        payload += b"\x00"
        mid |= consts.ID_ODD_SIZE
    words = len(payload) >> 1
    if words > 255:
        return bytes([mid | consts.ID_LARGE, words & 0xFF,
                      (words >> 8) & 0xFF, (words >> 16) & 0xFF]) + payload
    return bytes([mid, words]) + payload


def _u16(v: int) -> bytes:
    return bytes([v & 0xFF, (v >> 8) & 0xFF])


@dataclass
class CarryState:
    passes: list[EncPass]
    words: WordsState
    sample_index: int = 0


def _make_words_state(spec: EncodeSpec, medians) -> WordsState:
    # mono entropy metadata stores channel 0 only; the decoder's channel-1
    # medians stay 0 and feed the zero-run condition
    # (WordsUtils.cs:304) — mirror that exactly
    med1 = [0, 0, 0] if spec.nch_data == 1 else list(medians[1])
    w = WordsState(c=[EntropyChannel(median=list(medians[0])),
                      EntropyChannel(median=med1)])
    if spec.hybrid:
        w.bitrate_acc = [spec.bitrate << 16, spec.bitrate << 16]
        w.bitrate_delta = [spec.bitrate_delta, spec.bitrate_delta]
        if spec.hybrid_bitrate:
            for ch in (0, 1):
                w.c[ch].slow_level = 0
    return w


def _quantize_entropy(w: WordsState, mono: bool) -> bytes:
    out = bytearray()
    for ch in range(1 if mono else 2):
        for k in range(3):
            stored = mylog2(w.c[ch].median[k])
            out += _u16(stored)
            w.c[ch].median[k] = exp2s(stored)
    if mono:
        # stereo blocks require exactly 12 bytes; mono uses 6
        pass
    return bytes(out)


def _quantize_hybrid(spec: EncodeSpec, w: WordsState, mono: bool) -> bytes:
    out = bytearray()
    if spec.hybrid_bitrate:
        for ch in range(1 if mono else 2):
            stored = log2s(w.c[ch].slow_level)
            out += _u16(stored & 0xFFFF)
            w.c[ch].slow_level = exp2s(i16(stored))
    for ch in range(1 if mono else 2):
        stored = (w.bitrate_acc[ch] >> 16) & 0xFFFF
        out += _u16(stored)
        w.bitrate_acc[ch] = stored << 16
    if spec.bitrate_delta:
        for ch in range(1 if mono else 2):
            stored = log2s(w.bitrate_delta[ch])
            out += _u16(stored & 0xFFFF)
            w.bitrate_delta[ch] = exp2s(i16(stored))
    return bytes(out)


def _quantize_decorr(passes: list[EncPass], mono: bool
                     ) -> tuple[bytes, bytes, bytes]:
    terms = bytearray()
    for p in reversed(passes):
        terms.append(((p.term + 5) & 0x1F) | ((p.delta & 0x7) << 5))
    weights = bytearray()
    for p in reversed(passes):
        p.wa = i16(p.wa)
        b = store_weight(p.wa)
        weights.append(b)
        p.wa = restore_weight(b)
        if not mono:
            p.wb = i16(p.wb)
            b = store_weight(p.wb)
            weights.append(b)
            p.wb = restore_weight(b)
    samples = bytearray()

    def q(p: EncPass, hist: list[int], idx: int) -> None:
        stored = log2s(hist[idx])
        samples.extend(_u16(stored & 0xFFFF))
        hist[idx] = exp2s(i16(stored))

    for p in reversed(passes):
        if p.term > consts.MAX_TERM:
            q(p, p.sa, 0)
            q(p, p.sa, 1)
            if not mono:
                q(p, p.sb, 0)
                q(p, p.sb, 1)
        elif p.term < 0:
            q(p, p.sa, 0)
            q(p, p.sb, 0)
        else:
            for m in range(p.term):
                q(p, p.sa, m)
                if not mono:
                    q(p, p.sb, m)
    return bytes(terms), bytes(weights), bytes(samples)


# ---------------------------------------------------------------------------
# block encoding
# ---------------------------------------------------------------------------

def _stored_domain(pcm: np.ndarray, spec: EncodeSpec) -> np.ndarray:
    """Map final PCM values to the stored (pre-fixup) domain."""
    v = pcm.astype(np.int64)
    if spec.float_data:
        return v
    shift = spec.shift
    if spec.int32_mode == "wvx":
        return v >> spec.int32_sent_bits if spec.int32_sent_bits else v
    if spec.int32_mode == "zeros":
        return v >> spec.int32_zeros
    if spec.int32_mode == "ones":
        return ((v + 1) >> spec.int32_ones) - 1
    if spec.int32_mode == "dups":
        low = (v >> spec.int32_dups) & 1
        return ((v + low) >> spec.int32_dups) - low
    return v >> shift if shift else v


def encode_block(stored: np.ndarray, full_pcm: np.ndarray, spec: EncodeSpec,
                 carry: CarryState, block_index: int, total_samples: int,
                 is_first: bool, is_last: bool,
                 md5_digest: bytes | None = None,
                 wvc_sink: list | None = None) -> bytes:
    """Encode one block; `stored` is (n, ch_data) in the stored domain,
    `full_pcm` the original (for wvx low bits).

    With spec.wvc, the matching correction block's bytes are appended
    to `wvc_sink` (the caller concatenates them into the .wvc file)."""
    n = stored.shape[0]
    mono = spec.nch_data == 1
    # MAG field: mute_limit = 2^mag + 2 must exceed the largest |value| the
    # decoder reconstructs (UnpackUtils.cs:517); hybrid doubles it.
    maxabs = int(np.max(np.abs(stored))) if n else 0
    mag = maxabs.bit_length()
    flags = (spec.flags() | consts.INITIAL_BLOCK | consts.FINAL_BLOCK
             | (min(mag, 30) << consts.MAG_LSB))

    passes = carry.passes
    w = carry.words

    # --- metadata from (quantized) carried state ---
    terms_md, weights_md, samples_md = _quantize_decorr(passes, mono)
    if spec.version == 0x402 and spec.hybrid:
        # v4.02 hybrid prepends 2 bytes/channel that readers skip
        # (UnpackUtils.cs:277-283)
        samples_md = b"\x00\x00" * (1 if mono else 2) + samples_md
    entropy_md = _quantize_entropy(w, mono)
    hybrid_md = _quantize_hybrid(spec, w, mono) if spec.hybrid else None

    # reset per-block entropy transient state (read_entropy_vars clears
    # holding; zeros_acc is reset implicitly by block re-init)
    w.holding_one = w.holding_zero = False
    w.zeros_acc = 0
    for ch in (0, 1):
        w.c[ch].error_limit = 0

    use_wvc = bool(spec.wvc and spec.hybrid)
    if spec.wvc and not spec.hybrid:
        raise ValueError("wvc correction blocks require hybrid mode")
    if use_wvc and (spec.int32_mode == "wvx" or spec.float_data):
        raise ValueError(
            "wvc is not supported with wvx sent-bits or float content "
            "(real WavPack routes those bits inside the wvc file)")
    bw = BitWriter()
    cw = BitWriter() if use_wvc else None
    enc = EntropyEncoder(flags, w, bw, cw)

    # joint-stereo forward transform on the stored-domain targets
    targ = stored.astype(np.int64).copy()
    if not mono and (flags & consts.JOINT_STEREO):
        left = targ[:, 0].copy()
        right = targ[:, 1].copy()
        # int32 truncation wraps like C# (i32 semantics), vectorized
        sdiff = (left - right).astype(np.int32).astype(np.int64)
        targ[:, 0] = sdiff
        targ[:, 1] = (right + (sdiff >> 1)).astype(np.int32)

    decoded_stored = np.zeros_like(targ)

    # Native fast path (wvpk/native/csrc/wvpk_encode.c): bit-identical C
    # port of the per-sample loops below, lossless AND hybrid (~50x).
    # Degenerate regimes (wrapped medians) return None and fall through
    # to the Python loops, whose bignum arithmetic matches the oracle.
    native_payload = None
    native_wvc_payload = None
    if len(passes) <= 16:
        from .. import native as _native
        pstate = np.zeros((len(passes), _native.PSTATE_INTS), np.int32)
        for pi, p in enumerate(passes):
            pstate[pi, :5] = (p.term, p.delta, p.wa, p.wb, p.m)
            pstate[pi, 5:13] = p.sa
            pstate[pi, 13:21] = p.sb
        meds = np.array(list(w.c[0].median) + list(w.c[1].median), np.int32)
        wstate = np.array([w.c[0].slow_level, w.c[1].slow_level,
                           w.bitrate_acc[0], w.bitrate_acc[1],
                           w.bitrate_delta[0], w.bitrate_delta[1]],
                          np.int64)
        res = _native.encode_block_native(
            targ.astype(np.int32), mono, flags, pstate, meds, wstate,
            wvc=use_wvc)
        if res is not None:
            if use_wvc:
                native_payload, dec, native_wvc_payload = res
            else:
                native_payload, dec = res
            for pi, p in enumerate(passes):
                p.wa, p.wb, p.m = (int(pstate[pi, 2]), int(pstate[pi, 3]),
                                   int(pstate[pi, 4]))
                p.sa = [int(x) for x in pstate[pi, 5:13]]
                p.sb = [int(x) for x in pstate[pi, 13:21]]
            w.c[0].median = [int(x) for x in meds[:3]]
            w.c[1].median = [int(x) for x in meds[3:]]
            w.c[0].slow_level = int(wstate[0])
            w.c[1].slow_level = int(wstate[1])
            w.bitrate_acc = [int(wstate[2]), int(wstate[3])]
            decoded_stored = dec.astype(np.int64)

    if native_payload is not None:
        pass
    elif mono:
        t = 0
        while t < n:
            r = invert_mono(passes, int(targ[t, 0]))

            def zrun(t0=t):
                return _count_zero_run_mono(passes, enc, targ, t0)

            rhat = enc.encode_word(r, zrun)
            decoded_stored[t, 0] = reconstruct_mono(passes, rhat)
            t += 1
    else:
        t = 0
        while t < n:
            ra, rb = invert_stereo(passes, int(targ[t, 0]), int(targ[t, 1]))

            def zrun_a(t0=t):
                return _count_zero_run_stereo(passes, enc, targ, t0, 0)

            ra_hat = enc.encode_word(ra, zrun_a)
            # channel B residual with A's reconstruction visible to
            # intra-sample cross-channel terms: recompute after A known?
            # The chained inversion already used target values, which for
            # lossless equal reconstructions; for hybrid it is an encoder
            # choice. Decoder consistency comes from reconstruct_stereo.
            def zrun_b(t0=t):
                return _count_zero_run_stereo(passes, enc, targ, t0, 1)

            rb_hat = enc.encode_word(rb, zrun_b)
            oa, ob = reconstruct_stereo(passes, ra_hat, rb_hat)
            decoded_stored[t, 0] = oa
            decoded_stored[t, 1] = ob
            t += 1

    if native_payload is None:
        enc.finish()
    for p in passes:
        _rotate_ring(p, n)

    wv_payload = native_payload if native_payload is not None \
        else bw.getvalue()

    # --- wvx stream (int32 wvx mode) ---
    wvx_md = None
    if spec.int32_mode == "wvx" and spec.int32_sent_bits:
        wvx_md = _build_wvx(spec, decoded_stored, full_pcm, mono, flags)

    # --- assemble ---
    mdl = [mkmeta(consts.ID_DECORR_TERMS, terms_md),
           mkmeta(consts.ID_DECORR_WEIGHTS, weights_md),
           mkmeta(consts.ID_DECORR_SAMPLES, samples_md),
           mkmeta(consts.ID_ENTROPY_VARS, entropy_md)]
    if hybrid_md is not None:
        mdl.append(mkmeta(consts.ID_HYBRID_PROFILE, hybrid_md))
    if spec.float_data:
        mdl.append(mkmeta(consts.ID_FLOAT_INFO,
                          bytes([spec.float_flags, spec.float_shift,
                                 spec.float_max_exp, spec.float_norm_exp])))
    if spec.int32_mode is not None:
        mdl.append(mkmeta(consts.ID_INT32_INFO,
                          bytes([spec.int32_sent_bits, spec.int32_zeros,
                                 spec.int32_ones, spec.int32_dups])))
    if spec.sample_rate not in consts.SAMPLE_RATES:
        # non-standard rate: header srate field is 0xF (unknown), the
        # real rate travels as ID_SAMPLE_RATE (3-byte LE; read at
        # blockstate.py ID_SAMPLE_RATE / reference UnpackUtils.cs:461-472)
        mdl.append(mkmeta(consts.ID_SAMPLE_RATE,
                          (spec.sample_rate & 0xFFFFFF).to_bytes(3, "little")))
    if is_first and spec.config_flags:
        cf = spec.config_flags
        mdl.append(mkmeta(consts.ID_CONFIG_BLOCK,
                          bytes([(cf >> 8) & 0xFF, (cf >> 16) & 0xFF,
                                 (cf >> 24) & 0xFF])))
    if is_first and spec.riff_header is not None:
        mdl.append(mkmeta(consts.ID_RIFF_HEADER, spec.riff_header))
    mdl.append(mkmeta(consts.ID_WV_BITSTREAM, wv_payload))
    if wvx_md is not None:
        mdl.append(wvx_md)
    if is_last and md5_digest is not None:
        mdl.append(mkmeta(consts.ID_MD5_CHECKSUM, md5_digest))
    if is_last and spec.riff_trailer is not None:
        mdl.append(mkmeta(consts.ID_RIFF_TRAILER, spec.riff_trailer))
    body = b"".join(mdl)

    ck_size = HEADER_SIZE + len(body) - 8
    header = bytearray(HEADER_SIZE)
    header[0:4] = b"wvpk"
    header[4:8] = ck_size.to_bytes(4, "little")
    header[8:10] = spec.version.to_bytes(2, "little")
    header[10] = (block_index >> 32) & 0xFF
    header[11] = (total_samples >> 32) & 0xFF
    header[12:16] = (total_samples & 0xFFFFFFFF).to_bytes(4, "little")
    header[16:20] = (block_index & 0xFFFFFFFF).to_bytes(4, "little")
    header[20:24] = n.to_bytes(4, "little")
    header[24:28] = flags.to_bytes(4, "little")
    header[28:32] = b"\x00\x00\x00\x00"  # crc stamped below
    block = bytes(header) + body

    # --- stamp CRCs ---
    if wvx_md is None:
        # decoded_stored IS the decoder's pre-fixup output (that is the
        # whole contract of reconstruct_*), so the header CRC
        # (UnpackUtils.cs:577,626: crc = crc*3 + sample over the final
        # joint-undone values) follows in closed form -- no oracle
        # decode needed. Any encoder/decoder reconstruction divergence
        # now surfaces as a CRC error in the differential suites
        # instead of being masked by stamping the oracle's own value.
        final = decoded_stored
        if not mono and (flags & consts.JOINT_STEREO):
            # the CRC runs over the joint-UNDONE values
            # (UnpackUtils.cs:609-628: L += (R -= L>>1) happens before
            # the crc*3 accumulation)
            d = decoded_stored.astype(np.int64)
            r = (d[:, 1] - (d[:, 0] >> 1)).astype(np.int32)
            l = (d[:, 0] + r).astype(np.int32)
            final = np.stack([l, r], 1)
        blk = bytearray(block)
        blk[28:32] = _crc_fast(final).to_bytes(4, "little")
        block = bytes(blk)
    else:
        # wvx blocks also need crc_x over the post-injection values
        # (width-truncation quirks included): oracle-decode to stamp
        block = _stamp_crc(block)
    if spec.block_checksum:
        from ..container.checksum import add_block_checksum
        block = add_block_checksum(block, spec.block_checksum)

    if use_wvc:
        # the parallel correction block (one per audio block, same
        # header fields). Its crc covers the EXACT (lossless) samples —
        # the stored-domain source verbatim: decode's post-decorr
        # correction addition reproduces the joint-domain targets, and
        # the joint undo then yields `stored` (crc is computed before
        # the fixup shift, UnpackUtils.cs:626).
        wvc_body = mkmeta(consts.ID_WVC_BITSTREAM,
                          native_wvc_payload if native_payload is not None
                          else cw.getvalue())
        wvc_hdr = bytearray(header)
        wvc_hdr[4:8] = (HEADER_SIZE + len(wvc_body) - 8).to_bytes(
            4, "little")
        wvc_hdr[28:32] = _crc_fast(stored).to_bytes(4, "little")
        wvc_block = bytes(wvc_hdr) + wvc_body
        if spec.block_checksum:
            wvc_block = add_block_checksum(wvc_block, spec.block_checksum)
        if wvc_sink is not None:
            wvc_sink.append(wvc_block)
    return block


def _count_zero_run_mono(passes, enc: EntropyEncoder, targ, t0: int) -> int:
    sim = [p.clone() for p in passes]
    z = 0
    for t in range(t0, targ.shape[0]):
        r = invert_mono(sim, int(targ[t, 0]))
        if r != 0:
            break
        reconstruct_mono(sim, 0)
        z += 1
    return z


def _count_zero_run_stereo(passes, enc: EntropyEncoder, targ, t0: int,
                           ch0: int) -> int:
    """Count consecutive zero residuals in interleaved word order starting
    at sample t0, channel ch0."""
    sim = [p.clone() for p in passes]
    z = 0
    t = t0
    first = True
    while t < targ.shape[0]:
        ra, rb = invert_stereo(sim, int(targ[t, 0]), int(targ[t, 1]))
        if first and ch0 == 1:
            # channel A of this sample was already consumed as a run zero
            if rb != 0:
                break
            z += 1
            reconstruct_stereo(sim, 0, 0)
            t += 1
            first = False
            continue
        if ra != 0:
            break
        z += 1
        if rb != 0:
            break
        z += 1
        reconstruct_stereo(sim, 0, 0)
        t += 1
        first = False
    return z


def _build_wvx(spec: EncodeSpec, decoded_stored: np.ndarray,
               full_pcm: np.ndarray, mono: bool, flags: int) -> bytes:
    bw = BitWriter()
    new_style = spec.int32_max_width > 0
    if new_style:
        bw.putbits(spec.int32_max_width, 5)
    sent_bits = spec.int32_sent_bits
    mask = (1 << sent_bits) - 1
    n = decoded_stored.shape[0]
    nch = 1 if mono else 2
    for t in range(n):
        for ch in range(nch):
            v = int(decoded_stored[t, ch])
            if new_style:
                pvalue = ~v if v < 0 else v
                width = count_bits(pvalue) + sent_bits
                bits_to_read = sent_bits
                if width > spec.int32_max_width:
                    bits_to_read -= width - spec.int32_max_width
                if width <= spec.int32_max_width or bits_to_read > 0:
                    bw.putbits(int(full_pcm[t, ch]) & mask, bits_to_read)
            else:
                bw.putbits(int(full_pcm[t, ch]) & mask, sent_bits)
    payload = bw.getvalue()
    if len(payload) & 1:
        payload += b"\x00"
    mid = (consts.ID_WVX_NEW_BITSTREAM if new_style else consts.ID_WVX_BITSTREAM)
    return mkmeta(mid, b"\x00\x00\x00\x00" + payload)  # crc_mvx stamped later


def _crc_fast(decoded: np.ndarray, crc0: int = 0xFFFFFFFF) -> int:
    """Closed-form block CRC: crc_M = 3^M*crc0 + sum 3^(M-1-j)*x_j mod 2^32
    (the affine recurrence crc = crc*3 + x, UnpackUtils.cs:577,626, over
    the interleaved final values; numpy uint32 arithmetic wraps like C#)."""
    x = decoded.astype(np.int64).reshape(-1).astype(np.uint32)
    m = x.size
    if m == 0:
        return crc0
    p = np.full(m, 3, np.uint32)
    p[0] = 1
    p = np.multiply.accumulate(p)            # 3^j mod 2^32, j = 0..M-1
    acc = int(np.add.reduce(p[::-1] * x, dtype=np.uint32))
    return (acc + pow(3, m, 1 << 32) * crc0) & 0xFFFFFFFF


def _stamp_crc(block: bytes) -> bytes:
    """Oracle-decode the block and write the correct crc (and crc_mvx)."""
    from ..container import decode_block_state, iter_metadata, read_next_header
    from ..ref.oracle import unpack_samples

    hdr = read_next_header(block, 0)
    items = iter_metadata(block, hdr)
    st, _ = decode_block_state(hdr, items)
    res = unpack_samples(st)
    blk = bytearray(block)
    blk[28:32] = (res.crc & 0xFFFFFFFF).to_bytes(4, "little")
    if st.wvxbits is not None:
        # locate the wvx metadata payload to stamp crc_mvx
        pos = HEADER_SIZE
        while pos < len(blk):
            mid = blk[pos]
            length = blk[pos + 1] << 1
            hdr_len = 2
            if mid & consts.ID_LARGE:
                length += (blk[pos + 2] << 9) + (blk[pos + 3] << 17)
                hdr_len = 4
            stripped = mid & ~(consts.ID_ODD_SIZE | consts.ID_LARGE) & 0xFF
            if stripped in (consts.ID_WVX_BITSTREAM, consts.ID_WVX_NEW_BITSTREAM):
                blk[pos + hdr_len:pos + hdr_len + 4] = \
                    (res.crc_x & 0xFFFFFFFF).to_bytes(4, "little")
                break
            pos += hdr_len + length
    return bytes(blk)


# ---------------------------------------------------------------------------
# file encoding
# ---------------------------------------------------------------------------

def _auto_medians(stored: np.ndarray) -> tuple:
    mag = max(1, int(np.mean(np.abs(stored.astype(np.float64)))) >> 2)
    m = [exp2s(mylog2(mag)), exp2s(mylog2(mag * 2)), exp2s(mylog2(mag * 4))]
    return (tuple(m), tuple(m))


def encode_blocks(pcm: np.ndarray, spec: EncodeSpec, *,
                  start_sample: int = 0, first: bool = True,
                  last: bool = True, md5_digest: bytes | None = None,
                  carry: CarryState | None = None,
                  return_carry: bool = False,
                  wvc_sink: list | None = None):
    """Encode PCM (n, ch_data) into a list of WavPack block byte strings.

    The keyword hooks position `pcm` as one window of a larger stream
    (the bounded-memory streaming encoder in wvpk/encode.py):
    `start_sample` offsets block_index, `first`/`last` gate the
    file-level metadata (RIFF header / MD5 + trailer), `md5_digest`
    supplies a precomputed whole-file digest, and `carry` threads the
    adaptive encoder state across windows (pass the returned carry back
    in, with spec.total_samples_override holding the file total).
    Defaults encode `pcm` as a whole file, byte-identical to before.
    """
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    assert pcm.shape[1] == spec.nch_data
    if spec.wvc and any(t in (-1, -2) for t in spec.terms):
        # decode applies corrections AFTER the decorr chain (the chain
        # is linear in the residual for a fixed lossy-driven
        # prediction sequence). Terms -1/-2 predict from the OTHER
        # channel's CURRENT-sample output, so a decode-consistent
        # residual for one channel needs the other's quantized value
        # first — circular when both appear, and not what this
        # encoder's pure peel computes. The public surface maps
        # -1/-2 -> -3 (previous-sample cross prediction) under wvc.
        raise ValueError(
            "wvc requires a chain without intra-sample cross terms "
            "(-1/-2); use -3 or a wvc preset")
    stored = _stored_domain(pcm, spec)
    total = spec.total_samples_override
    if total is None:
        total = pcm.shape[0]
    if spec.md5 and last and md5_digest is None:
        import hashlib

        from ..io.pcm import format_samples
        out = pcm
        if spec.false_stereo:   # decoder duplicates to 2 channels
            out = np.repeat(pcm, 2, axis=1)
        md5_digest = hashlib.md5(format_samples(
            out, spec.bytes_stored)).digest()
    if carry is None:
        medians = spec.initial_medians or _auto_medians(stored)
        carry = CarryState(
            passes=[EncPass(t, d) for t, d in zip(spec.terms, spec.deltas)],
            words=_make_words_state(spec, medians))
    blocks = []
    n = pcm.shape[0]
    bs = spec.block_samples
    for start in range(0, n, bs):
        end = min(start + bs, n)
        blocks.append(encode_block(
            stored[start:end], pcm[start:end], spec, carry,
            block_index=start_sample + start, total_samples=total,
            is_first=first and start == 0, is_last=last and end >= n,
            md5_digest=md5_digest if spec.md5 else None,
            wvc_sink=wvc_sink))
    if return_carry:
        return blocks, carry
    return blocks


def encode_file(pcm: np.ndarray, spec: EncodeSpec) -> bytes:
    return b"".join(encode_blocks(pcm, spec))
