"""Scalar oracle decoder: the golden model the TPU pipeline must match.

A from-scratch Python implementation of the WavPack 4/5 decode semantics
documented in SURVEY.md sections 2-3 (reference call sites cited per
function). It favors clarity and exactness over speed: all arithmetic uses
Python ints with explicit 32-bit wraps matching C# `int` truncation.

The bitstream model: the reference keeps a shift-register window `sr` of
`bc` valid bits over the LSB-first byte stream (reference BitsUtils.cs:15-68).
`getbits(n)` returns the whole window (>= n bits; callers mask), so decoded
values can include deterministic lookahead bits — this matters in the wvx
width-truncation path (reference UnpackUtils.cs:1286-1292). We therefore
track (pos, bc) exactly. Bytes past the payload read as 0xff with the error
flag set (reference BitsUtils.cs:123-140).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import consts
from ..container.blockstate import BlockState
from ..tables import ONES_COUNT_TABLE, count_bits, exp2s, i32, i64, mylog2


class OracleBitstream:
    """LSB-first bit reader with the reference's window semantics."""

    __slots__ = ("data", "nbits", "pos", "bc", "error")

    def __init__(self, data: bytes, start_bit: int = 0):
        self.data = data
        self.nbits = len(data) * 8
        self.pos = start_bit
        self.bc = 0
        self.error = 0

    def _bit(self, i: int) -> int:
        if i >= self.nbits:
            self.error = 1
            return 1  # 0xff fill
        return (self.data[i >> 3] >> (i & 7)) & 1

    def _window(self, nbits: int) -> int:
        v = 0
        for k in range(nbits):
            v |= self._bit(self.pos + k) << k
        return v

    def getbit(self) -> int:
        # BitsUtils.cs:15-35
        if self.bc > 0:
            self.bc -= 1
        else:
            self.bc = 7
        b = self._bit(self.pos)
        self.pos += 1
        return b

    def getbits(self, nbits: int) -> int:
        # BitsUtils.cs:37-68; returns the full window, callers mask.
        while nbits > self.bc:
            self.bc += 8
        ret = self._window(min(self.bc, 32))
        self.bc -= nbits
        self.pos += nbits
        return ret

    def refill_byte_if_low(self) -> None:
        # the inline refill in get_words (WordsUtils.cs:361-372)
        if self.bc < 8:
            self.bc += 8

    def peek_byte(self) -> int:
        return self._window(8)

    def consume(self, n: int) -> None:
        self.pos += n
        self.bc -= n


@dataclass
class EntropyChannel:
    median: list[int] = field(default_factory=lambda: [0, 0, 0])
    slow_level: int = 0
    error_limit: int = 0


@dataclass
class WordsState:
    c: list[EntropyChannel]
    holding_one: bool = False
    holding_zero: bool = False
    zeros_acc: int = 0
    bitrate_acc: list[int] = field(default_factory=lambda: [0, 0])
    bitrate_delta: list[int] = field(default_factory=lambda: [0, 0])

    @classmethod
    def from_block(cls, st: BlockState) -> "WordsState":
        w = cls(c=[EntropyChannel(median=list(st.medians[0]), slow_level=st.slow_level[0]),
                   EntropyChannel(median=list(st.medians[1]), slow_level=st.slow_level[1])])
        w.bitrate_acc = list(st.bitrate_acc)
        w.bitrate_delta = list(st.bitrate_delta)
        return w


def update_error_limit(w: WordsState, flags: int) -> None:
    # WordsUtils.cs:195-261; bitrate_acc is a signed C# long
    w.bitrate_acc[0] = i64(w.bitrate_acc[0] + w.bitrate_delta[0])
    bitrate_0 = i32(w.bitrate_acc[0] >> 16)
    if flags & consts.MONO_DATA:
        if flags & consts.HYBRID_BITRATE:
            slow_log_0 = (w.c[0].slow_level + consts.SLO) >> consts.SLS
            if slow_log_0 - bitrate_0 > -0x100:
                w.c[0].error_limit = exp2s(slow_log_0 - bitrate_0 + 0x100)
            else:
                w.c[0].error_limit = 0
        else:
            w.c[0].error_limit = exp2s(bitrate_0)
    else:
        w.bitrate_acc[1] = i64(w.bitrate_acc[1] + w.bitrate_delta[1])
        bitrate_1 = i32(w.bitrate_acc[1] >> 16)
        if flags & consts.HYBRID_BITRATE:
            slow_log_0 = (w.c[0].slow_level + consts.SLO) >> consts.SLS
            slow_log_1 = (w.c[1].slow_level + consts.SLO) >> consts.SLS
            if flags & consts.HYBRID_BALANCE:
                balance = (slow_log_1 - slow_log_0 + bitrate_1 + 1) >> 1
                if balance > bitrate_0:
                    bitrate_1 = bitrate_0 * 2
                    bitrate_0 = 0
                elif -balance > bitrate_0:
                    bitrate_0 = bitrate_0 * 2
                    bitrate_1 = 0
                else:
                    bitrate_1 = bitrate_0 + balance
                    bitrate_0 = bitrate_0 - balance
            if slow_log_0 - bitrate_0 > -0x100:
                w.c[0].error_limit = exp2s(slow_log_0 - bitrate_0 + 0x100)
            else:
                w.c[0].error_limit = 0
            if slow_log_1 - bitrate_1 > -0x100:
                w.c[1].error_limit = exp2s(slow_log_1 - bitrate_1 + 0x100)
            else:
                w.c[1].error_limit = 0
        else:
            w.c[0].error_limit = exp2s(bitrate_0)
            w.c[1].error_limit = exp2s(bitrate_1)


def median_interval(c: EntropyChannel, ones_count: int) -> tuple[int, int]:
    """Map ones_count to a [low, high] residual interval and adapt medians
    with the 5/7-2/7 rule (WordsUtils.cs:433-475). Shared with the encoder
    so both sides adapt identically. Median updates wrap at int32 like the
    reference's C# ints (the reference degrades on streams whose residuals
    drive medians past 2^31; real encoders keep stored residuals ~24 bits
    via INT32 handling, see readme.txt "limited in resolution")."""
    m0, m1, m2 = c.median
    if ones_count == 0:
        low = 0
        high = (m0 >> 4) + 1 - 1
        c.median[0] = i32(m0 - ((m0 + (consts.DIV0 - 2)) >> 7) * 2)
    else:
        low = (m0 >> 4) + 1
        c.median[0] = i32(m0 + ((m0 + consts.DIV0) >> 7) * 5)
        if ones_count == 1:
            high = low + (m1 >> 4) + 1 - 1
            c.median[1] = i32(m1 - ((m1 + (consts.DIV1 - 2)) >> 6) * 2)
        else:
            low += (m1 >> 4) + 1
            c.median[1] = i32(m1 + ((m1 + consts.DIV1) >> 6) * 5)
            if ones_count == 2:
                high = low + (m2 >> 4) + 1 - 1
                c.median[2] = i32(m2 - ((m2 + (consts.DIV2 - 2)) >> 5) * 2)
            else:
                low += (ones_count - 2) * ((m2 >> 4) + 1)
                high = low + (m2 >> 4) + 1 - 1
                c.median[2] = i32(m2 + ((m2 + consts.DIV2) >> 5) * 5)
    return low, high


def read_code(bs: OracleBitstream, maxcode: int) -> int:
    # minimal binary code (WordsUtils.cs:546-570)
    bitcount = count_bits(maxcode)
    if bitcount == 0:
        return 0
    extras = (1 << bitcount) - maxcode - 1
    code = bs.getbits(bitcount - 1) & ((1 << (bitcount - 1)) - 1)
    if code >= extras:
        code = (code << 1) - extras
        if bs.getbit():
            code += 1
    return code


def get_words(nsamples: int, flags: int, w: WordsState, bs: OracleBitstream,
              buffer: list[int], start: int = 0,
              wvc_bs: "OracleBitstream | None" = None,
              corrections: "list[int] | None" = None) -> int:
    """Entropy word decoder, hot loop 1 (WordsUtils.cs:272-511).

    With `wvc_bs` (hybrid-lossless correction stream, beyond-parity:
    the reference parses it at UnpackUtils.cs:93-108 but never decodes
    it), every error_limit-quantized word also reads a minimal-binary
    code over the narrowed [low, high] interval; `corrections` receives
    one signed sample-domain correction per buffer slot written, such
    that lossy_word + correction == the exact residual."""
    mono = bool(flags & consts.MONO_DATA)
    if not mono:
        nsamples *= 2
    entidx = 0 if mono else 1
    bptr = start
    csamples = 0
    while csamples < nsamples:
        if not mono:
            entidx = 0 if entidx == 1 else 1

        if ((w.c[0].median[0] & ~1) == 0 and not w.holding_zero
                and not w.holding_one and (w.c[1].median[0] & ~1) == 0):
            if w.zeros_acc > 0:
                w.zeros_acc -= 1
                if w.zeros_acc > 0:
                    c = w.c[entidx]
                    c.slow_level -= (c.slow_level + consts.SLO) >> consts.SLS
                    buffer[bptr] = 0
                    if corrections is not None:
                        corrections.append(0)
                    bptr += 1
                    csamples += 1
                    continue
            else:
                cbits = 0
                while cbits < 33 and bs.getbit():
                    cbits += 1
                if cbits == 33:
                    break
                if cbits < 2:
                    w.zeros_acc = cbits
                else:
                    mask = 1
                    w.zeros_acc = 0
                    cbits -= 1
                    while cbits > 0:
                        if bs.getbit():
                            w.zeros_acc |= mask
                        mask <<= 1
                        cbits -= 1
                    w.zeros_acc |= mask
                if w.zeros_acc > 0:
                    c = w.c[entidx]
                    c.slow_level -= (c.slow_level + consts.SLO) >> consts.SLS
                    for ch in (0, 1):
                        w.c[ch].median[0] = 0
                        w.c[ch].median[1] = 0
                        w.c[ch].median[2] = 0
                    buffer[bptr] = 0
                    if corrections is not None:
                        corrections.append(0)
                    bptr += 1
                    csamples += 1
                    continue

        if w.holding_zero:
            w.holding_zero = False
            ones_count = 0
        else:
            bs.refill_byte_if_low()
            next8 = bs.peek_byte()
            if next8 == 0xFF:
                bs.consume(8)
                ones_count = 8
                while ones_count < consts.LIMIT_ONES + 1 and bs.getbit():
                    ones_count += 1
                if ones_count == consts.LIMIT_ONES + 1:
                    break
                if ones_count == consts.LIMIT_ONES:
                    cbits = 0
                    while cbits < 33 and bs.getbit():
                        cbits += 1
                    if cbits == 33:
                        break
                    if cbits < 2:
                        ones_count = cbits
                    else:
                        mask = 1
                        ones_count = 0
                        cbits -= 1
                        while cbits > 0:
                            if bs.getbit():
                                ones_count |= mask
                            mask <<= 1
                            cbits -= 1
                        ones_count |= mask
                    ones_count += consts.LIMIT_ONES
            else:
                ones_count = ONES_COUNT_TABLE[next8]
                bs.consume(ones_count + 1)
            if w.holding_one:
                w.holding_one = (ones_count & 1) != 0
                ones_count = (ones_count >> 1) + 1
            else:
                w.holding_one = (ones_count & 1) != 0
                ones_count >>= 1
            w.holding_zero = not w.holding_one

        if (flags & consts.HYBRID_FLAG) and (mono or (csamples & 1) == 0):
            update_error_limit(w, flags)

        c = w.c[entidx]
        low, high = median_interval(c, ones_count)
        mid = (high + low + 1) >> 1
        mag_delta = 0
        if c.error_limit == 0:
            mid = read_code(bs, high - low) + low
        else:
            while high - low > c.error_limit:
                if bs.getbit():
                    low = mid
                    mid = (high + low + 1) >> 1
                else:
                    high = mid - 1
                    mid = (high + low + 1) >> 1
            if wvc_bs is not None:
                # exact magnitude = low + code over the narrowed interval
                mag_delta = read_code(wvc_bs, high - low) + low - mid

        if bs.getbit():
            buffer[bptr] = i32(~mid)
            if corrections is not None:
                corrections.append(-mag_delta)
        else:
            buffer[bptr] = i32(mid)
            if corrections is not None:
                corrections.append(mag_delta)
        bptr += 1

        if flags & consts.HYBRID_BITRATE:
            c.slow_level = c.slow_level - ((c.slow_level + consts.SLO) >> consts.SLS) \
                + mylog2(mid)
        csamples += 1

    return csamples if mono else csamples // 2


# ---------------------------------------------------------------------------
# decorrelation passes (UnpackUtils.cs:688-1240)
# ---------------------------------------------------------------------------

def _apw(weight: int, sam: int, value: int) -> int:
    """The decorr predictor: (weight*sam + 512) >> 10 in 64-bit, plus value,
    truncated to int32 (UnpackUtils.cs:705 etc.)."""
    return i32(((weight * sam + 512) >> 10) + value)


def _upd(weight: int, delta: int, sam: int, value: int) -> int:
    if sam != 0 and value != 0:
        weight += delta if (i32(sam) ^ i32(value)) >= 0 else -delta
    return weight


def _upd_clamp(weight: int, delta: int, sam: int, value: int) -> int:
    # negative-term weight update with +/-1024 clamp (UnpackUtils.cs:776-799)
    if (i32(sam) ^ i32(value)) < 0:
        if sam != 0 and value != 0:
            weight -= delta
            if weight < -1024:
                weight = -1024 if weight < 0 else 1024
    else:
        if sam != 0 and value != 0:
            weight += delta
            if weight > 1024:
                weight = -1024 if weight < 0 else 1024
    return weight


class DecorrPass:
    __slots__ = ("term", "delta", "weight_a", "weight_b", "samples_a", "samples_b")

    def __init__(self, term, delta, weight_a, weight_b, samples_a, samples_b):
        self.term = int(term)
        self.delta = int(delta)
        self.weight_a = int(weight_a)
        self.weight_b = int(weight_b)
        self.samples_a = [int(x) for x in samples_a]
        self.samples_b = [int(x) for x in samples_b]


def decorr_stereo_pass(dpp: DecorrPass, buf: list[int], sample_count: int,
                       idx: int) -> None:
    # UnpackUtils.cs:688-944
    delta, wa, wb = dpp.delta, dpp.weight_a, dpp.weight_b
    t = dpp.term
    if t == 17 or t == 18:
        for p in range(idx, idx + sample_count * 2, 2):
            for ch, (hist, w) in enumerate(((dpp.samples_a, wa), (dpp.samples_b, wb))):
                if t == 17:
                    sam = i32(2 * hist[0] - hist[1])
                else:
                    sam = i32((3 * hist[0] - hist[1]) >> 1)
                hist[1] = hist[0]
                hist[0] = _apw(w, sam, buf[p + ch])
                w = _upd(w, delta, sam, buf[p + ch])
                buf[p + ch] = hist[0]
                if ch == 0:
                    wa = w
                else:
                    wb = w
    elif t == -1:
        for p in range(idx, idx + sample_count * 2, 2):
            sam_a = _apw(wa, dpp.samples_a[0], buf[p])
            wa = _upd_clamp(wa, delta, dpp.samples_a[0], buf[p])
            buf[p] = sam_a
            dpp.samples_a[0] = _apw(wb, sam_a, buf[p + 1])
            wb = _upd_clamp(wb, delta, sam_a, buf[p + 1])
            buf[p + 1] = dpp.samples_a[0]
    elif t == -2:
        for p in range(idx, idx + sample_count * 2, 2):
            sam_b = _apw(wb, dpp.samples_b[0], buf[p + 1])
            wb = _upd_clamp(wb, delta, dpp.samples_b[0], buf[p + 1])
            buf[p + 1] = sam_b
            dpp.samples_b[0] = _apw(wa, sam_b, buf[p])
            wa = _upd_clamp(wa, delta, sam_b, buf[p])
            buf[p] = dpp.samples_b[0]
    elif t == -3:
        for p in range(idx, idx + sample_count * 2, 2):
            sam_a = _apw(wa, dpp.samples_a[0], buf[p])
            wa = _upd_clamp(wa, delta, dpp.samples_a[0], buf[p])
            sam_b = _apw(wb, dpp.samples_b[0], buf[p + 1])
            wb = _upd_clamp(wb, delta, dpp.samples_b[0], buf[p + 1])
            buf[p] = dpp.samples_b[0] = sam_a
            buf[p + 1] = dpp.samples_a[0] = sam_b
    else:
        m, k = 0, t & (consts.MAX_TERM - 1)
        for p in range(idx, idx + sample_count * 2, 2):
            sam = dpp.samples_a[m]
            dpp.samples_a[k] = _apw(wa, sam, buf[p])
            wa = _upd(wa, delta, sam, buf[p])
            buf[p] = dpp.samples_a[k]
            sam = dpp.samples_b[m]
            dpp.samples_b[k] = _apw(wb, sam, buf[p + 1])
            wb = _upd(wb, delta, sam, buf[p + 1])
            buf[p + 1] = dpp.samples_b[k]
            m = (m + 1) & (consts.MAX_TERM - 1)
            k = (k + 1) & (consts.MAX_TERM - 1)
        if m != 0:
            for hist in (dpp.samples_a, dpp.samples_b):
                tmp = list(hist)
                for kk in range(consts.MAX_TERM):
                    hist[kk] = tmp[(m + kk) & (consts.MAX_TERM - 1)]
    dpp.weight_a, dpp.weight_b = _i16w(wa), _i16w(wb)


def _i16w(w: int) -> int:
    # the reference casts weights to short at pass end (UnpackUtils.cs:942)
    w &= 0xFFFF
    return w - 0x10000 if w >= 0x8000 else w


def decorr_stereo_pass_cont(dpp: DecorrPass, buf: list[int], sample_count: int,
                            idx: int) -> None:
    # UnpackUtils.cs:946-1154: history comes from the output buffer itself.
    delta, wa, wb = dpp.delta, dpp.weight_a, dpp.weight_b
    t = dpp.term
    end = idx + sample_count * 2
    if t in (17, 18):
        for p in range(idx, end, 2):
            if t == 17:
                sam = i32(2 * buf[p - 2] - buf[p - 4])
            else:
                sam = i32((3 * buf[p - 2] - buf[p - 4]) >> 1)
            sb = buf[p]
            buf[p] = _apw(wa, sam, sb)
            if sam != 0 and sb != 0:
                wa += (((i32(sam) ^ i32(sb)) >> 30) | 1) * delta
            if t == 17:
                sam = i32(2 * buf[p - 1] - buf[p - 3])
            else:
                sam = i32((3 * buf[p - 1] - buf[p - 3]) >> 1)
            sb = buf[p + 1]
            buf[p + 1] = _apw(wb, sam, sb)
            if sam != 0 and sb != 0:
                wb += (((i32(sam) ^ i32(sb)) >> 30) | 1) * delta
        dpp.samples_b[0] = buf[end - 1]
        dpp.samples_a[0] = buf[end - 2]
        dpp.samples_b[1] = buf[end - 3]
        dpp.samples_a[1] = buf[end - 4]
    elif t == -1:
        for p in range(idx, end, 2):
            sam = buf[p]
            buf[p] = _apw(wa, buf[p - 1], sam)
            wa = _upd_clamp(wa, delta, buf[p - 1], sam)
            sam = buf[p + 1]
            buf[p + 1] = _apw(wb, buf[p], sam)
            wb = _upd_clamp(wb, delta, buf[p], sam)
        dpp.samples_a[0] = buf[end - 1]
    elif t == -2:
        for p in range(idx, end, 2):
            sam = buf[p + 1]
            buf[p + 1] = _apw(wb, buf[p - 2], sam)
            wb = _upd_clamp(wb, delta, buf[p - 2], sam)
            sam = buf[p]
            buf[p] = _apw(wa, buf[p + 1], sam)
            wa = _upd_clamp(wa, delta, buf[p + 1], sam)
        dpp.samples_b[0] = buf[end - 2]
    elif t == -3:
        for p in range(idx, end, 2):
            sam = buf[p]
            buf[p] = _apw(wa, buf[p - 1], sam)
            wa = _upd_clamp(wa, delta, buf[p - 1], sam)
            sam = buf[p + 1]
            buf[p + 1] = _apw(wb, buf[p - 2], sam)
            wb = _upd_clamp(wb, delta, buf[p - 2], sam)
        dpp.samples_a[0] = buf[end - 1]
        dpp.samples_b[0] = buf[end - 2]
    else:
        tptr = idx - t * 2
        for p in range(idx, end, 2):
            sam = buf[p]
            buf[p] = _apw(wa, buf[tptr], sam)
            if buf[tptr] != 0 and sam != 0:
                wa += (((i32(buf[tptr]) ^ i32(sam)) >> 30) | 1) * delta
            sam = buf[p + 1]
            buf[p + 1] = _apw(wb, buf[tptr + 1], sam)
            if buf[tptr + 1] != 0 and sam != 0:
                wb += (((i32(buf[tptr + 1]) ^ i32(sam)) >> 30) | 1) * delta
            tptr += 2
        bi = end - 1
        k, i = t - 1, 8
        while i > 0:
            i -= 1
            dpp.samples_b[k & (consts.MAX_TERM - 1)] = buf[bi]
            bi -= 1
            dpp.samples_a[k & (consts.MAX_TERM - 1)] = buf[bi]
            bi -= 1
            k -= 1
    dpp.weight_a, dpp.weight_b = _i16w(wa), _i16w(wb)


def decorr_mono_pass(dpp: DecorrPass, buf: list[int], sample_count: int,
                     idx: int) -> None:
    # UnpackUtils.cs:1156-1240
    delta, wa = dpp.delta, dpp.weight_a
    t = dpp.term
    if t in (17, 18):
        for p in range(idx, idx + sample_count):
            if t == 17:
                sam = i32(2 * dpp.samples_a[0] - dpp.samples_a[1])
            else:
                sam = i32((3 * dpp.samples_a[0] - dpp.samples_a[1]) >> 1)
            dpp.samples_a[1] = dpp.samples_a[0]
            dpp.samples_a[0] = _apw(wa, sam, buf[p])
            wa = _upd(wa, delta, sam, buf[p])
            buf[p] = dpp.samples_a[0]
    else:
        m, k = 0, t & (consts.MAX_TERM - 1)
        for p in range(idx, idx + sample_count):
            sam = dpp.samples_a[m]
            dpp.samples_a[k] = _apw(wa, sam, buf[p])
            wa = _upd(wa, delta, sam, buf[p])
            buf[p] = dpp.samples_a[k]
            m = (m + 1) & (consts.MAX_TERM - 1)
            k = (k + 1) & (consts.MAX_TERM - 1)
        if m != 0:
            tmp = list(dpp.samples_a)
            for kk in range(consts.MAX_TERM):
                dpp.samples_a[kk] = tmp[(m + kk) & (consts.MAX_TERM - 1)]
    dpp.weight_a = _i16w(wa)


# ---------------------------------------------------------------------------
# fixup / post-process (UnpackUtils.cs:1251-1404, FloatUtils.cs:32-56)
# ---------------------------------------------------------------------------

def float_values(st: BlockState, buf: list[int], num_values: int, start: int) -> None:
    shift = st.float_max_exp - st.float_norm_exp + st.float_shift
    shift = max(-32, min(32, shift))
    # C# int shift counts are mod-32 (FloatUtils.cs:42-45), so the
    # clamped +/-32 shift is a NO-OP, not a zero/sign fill — the value
    # passes through unshifted and only the 24-bit clip applies
    for p in range(start, start + num_values):
        v = buf[p]
        if shift > 0:
            v = i32(v << (shift & 31))
        elif shift < 0:
            v = v >> ((-shift) & 31)
        buf[p] = max(-8388608, min(8388607, v))


def fixup_samples(st: BlockState, buf: list[int], sample_count: int,
                  wvx: OracleBitstream | None, crc_x: int,
                  start: int = 0) -> int:
    flags = st.flags
    lossy = bool(flags & consts.HYBRID_FLAG)
    shift = (flags & consts.SHIFT_MASK) >> consts.SHIFT_LSB

    if flags & consts.FLOAT_DATA:
        n = sample_count if flags & consts.MONO_FLAG else sample_count * 2
        float_values(st, buf, n, start)
        return crc_x

    if flags & consts.INT32_DATA:
        count = sample_count if flags & consts.MONO_FLAG else sample_count * 2
        sent_bits, zeros = st.int32_sent_bits, st.int32_zeros
        ones, dups = st.int32_ones, st.int32_dups
        # C# int/uint shift counts are mod-32 — reachable only through
        # corrupt metadata bytes (conforming encoders keep these < 32);
        # every shift below masks its count for parity
        mask = (1 << (sent_bits & 31)) - 1
        p = start
        if wvx is not None:
            max_width = st.int32_max_width
            for _ in range(count):
                v = buf[p]
                if sent_bits:
                    if max_width:
                        pvalue = ~v if v < 0 else v
                        width = count_bits(pvalue) + sent_bits
                        bits_to_read = sent_bits
                        if width > max_width:
                            bits_to_read -= width - max_width
                        if width <= max_width or bits_to_read > 0:
                            data = wvx.getbits(bits_to_read) & mask
                            v = i32((i32(v << (bits_to_read & 31)) | data)
                                    << ((sent_bits - bits_to_read) & 31))
                        else:
                            v = i32(v << (sent_bits & 31))
                    else:
                        data = wvx.getbits(sent_bits) & mask
                        v = i32(i32(v << (sent_bits & 31)) | data)
                if zeros:
                    v = i32(v << (zeros & 31))
                elif ones:
                    v = i32(((v + 1) << (ones & 31)) - 1)
                elif dups:
                    v = i32(((v + (v & 1)) << (dups & 31)) - (v & 1))
                crc_x = i32(crc_x * 9 + (v & 0xFFFF) * 3 + ((v >> 16) & 0xFFFF))
                buf[p] = v
                p += 1
        elif sent_bits == 0 and (zeros + ones + dups) != 0:
            while lossy and (flags & consts.BYTES_STORED) == 3 and shift < 8:
                if zeros > 0:
                    zeros -= 1
                elif ones > 0:
                    ones -= 1
                elif dups > 0:
                    dups -= 1
                else:
                    break
                shift += 1
            for _ in range(count):
                v = buf[p]
                if zeros:
                    v = i32(v << (zeros & 31))
                elif ones:
                    v = i32(((v + 1) << (ones & 31)) - 1)
                elif dups:
                    v = i32(((v + (v & 1)) << (dups & 31)) - (v & 1))
                buf[p] = v
                p += 1
        else:
            shift += zeros + sent_bits + ones + dups

    shift &= 0x1F
    n = sample_count if flags & consts.MONO_FLAG else sample_count * 2
    if lossy:
        bs = flags & consts.BYTES_STORED
        if bs == 0:
            min_value, max_value = -128 >> shift, 127 >> shift
        elif bs == 1:
            min_value, max_value = -32768 >> shift, 32767 >> shift
        elif bs == 2:
            min_value, max_value = -8388608 >> shift, 8388607 >> shift
        else:
            # C#: 0x80000000 is uint, so the shift is logical
            # (UnpackUtils.cs:1374)
            min_value = i32(0x80000000 >> shift)
            max_value = 0x7FFFFFFF >> shift
        min_shifted, max_shifted = i32(min_value << shift), i32(max_value << shift)
        for p in range(start, start + n):
            if buf[p] < min_value:
                buf[p] = min_shifted
            elif buf[p] > max_value:
                buf[p] = max_shifted
            else:
                buf[p] = i32(buf[p] << shift)
    elif shift:
        for p in range(start, start + n):
            buf[p] = i32(buf[p] << shift)
    return crc_x


# ---------------------------------------------------------------------------
# whole-block unpack (UnpackUtils.cs:510-686)
# ---------------------------------------------------------------------------

@dataclass
class BlockResult:
    samples: np.ndarray      # (n, ch) int32, ch = 2 unless true mono
    crc: int
    crc_x: int
    mute_error: bool
    crc_error: bool
    # hybrid-lossless (wvc) extras: crc over the corrected (exact)
    # samples and whether it matched the correction block's header crc
    crc_wvc: int = -1
    wvc_applied: bool = False


def unpack_samples(st: BlockState) -> BlockResult:
    """Decode one whole PCM block (DSD handled in dsd module)."""
    flags = st.flags
    hdr = st.header
    sample_count = hdr.block_samples
    crc = -1
    crc_x = -1
    mute_error = False

    # C# int truncation on (1L << mag) + 2 and the hybrid doubling
    # (UnpackUtils.cs:517,546); mag == 31 makes this negative, muting
    # everything — faithful to the reference.
    mag = (flags & consts.MAG_MASK) >> consts.MAG_LSB
    mute_limit = i32((1 << mag) + 2)
    if flags & consts.HYBRID_FLAG:
        mute_limit = i32(mute_limit * 2)

    def cabs(v: int) -> int:
        # C# unchecked abs: -int.MinValue wraps back to int.MinValue
        return i32(-v) if v < 0 else v

    bs = OracleBitstream(st.wvbits or b"")
    wvx = OracleBitstream(st.wvxbits, st.wvx_start_bit) if st.wvxbits else None
    # hybrid-lossless: a paired correction stream (attached by
    # container.pair_wvc) upgrades this block to exact decode. An EMPTY
    # payload is a valid pairing (an all-zero-run block needs no
    # correction bits), so test presence, not truthiness.
    has_wvc = st.wvcbits is not None and bool(flags & consts.HYBRID_FLAG)
    wvc_bs = OracleBitstream(st.wvcbits) if has_wvc else None
    corr: list[int] | None = [] if has_wvc else None
    w = WordsState.from_block(st)
    passes = [DecorrPass(st.terms[j], st.deltas[j], st.weights_a[j], st.weights_b[j],
                         st.samples_a[j], st.samples_b[j])
              for j in range(st.num_terms)]

    mono = bool(flags & consts.MONO_DATA)
    # buffer width follows MONO_FLAG (not MONO_DATA): a FALSE_STEREO block
    # decodes mono data but fixup_samples runs over 2x entries, the upper
    # half zeros (reference fixup count, UnpackUtils.cs:1265)
    nvals = sample_count if flags & consts.MONO_FLAG else sample_count * 2
    buf = [0] * nvals

    i = get_words(sample_count, flags, w, bs, buf,
                  wvc_bs=wvc_bs, corrections=corr)
    if mono:
        for dpp in passes:
            decorr_mono_pass(dpp, buf, sample_count, 0)
    else:
        if sample_count < 16:
            for dpp in passes:
                decorr_stereo_pass(dpp, buf, sample_count, 0)
        else:
            for dpp in passes:
                decorr_stereo_pass(dpp, buf, 8, 0)
                decorr_stereo_pass_cont(dpp, buf, sample_count - 8, 16)

    # hybrid-lossless: corrections add AFTER the decorr chain (it is
    # linear in the residual for the lossy-driven prediction sequence)
    # and BEFORE the joint-stereo undo; the main loops below then run on
    # the exact values, and the lossy crc for the wv header check is
    # replayed from a snapshot afterwards
    buf_lossy: list[int] | None = None
    if has_wvc:
        buf_lossy = list(buf)
        for k in range(min(len(corr), len(buf))):
            if corr[k]:
                buf[k] = i32(buf[k] + corr[k])

    if mono:
        for q in range(sample_count):
            v = buf[q]
            if cabs(v) > mute_limit:
                i = q
                break
            crc = i32(crc * 3 + v)
    else:
        if flags & consts.JOINT_STEREO:
            for q in range(0, sample_count * 2, 2):
                buf[q + 1] = i32(buf[q + 1] - (buf[q] >> 1))
                buf[q] = i32(buf[q] + buf[q + 1])
                if cabs(buf[q]) > mute_limit or cabs(buf[q + 1]) > mute_limit:
                    i = q // 2
                    break
                crc = i32(i32(crc * 3 + buf[q]) * 3 + buf[q + 1])
        else:
            for q in range(0, sample_count * 2, 2):
                if cabs(buf[q]) > mute_limit or cabs(buf[q + 1]) > mute_limit:
                    i = q // 2
                    break
                crc = i32(i32(crc * 3 + buf[q]) * 3 + buf[q + 1])

    crc_wvc = -1
    if has_wvc:
        # the main loops above accumulated the EXACT crc (correction
        # block's header check); the wv header crc covers the lossy
        # reconstruction — replay it from the pre-correction snapshot
        crc_wvc = crc

        def _replay_lossy_crc(b: list[int]) -> int:
            cl = -1
            if mono:
                for q in range(sample_count):
                    if cabs(b[q]) > mute_limit:
                        break
                    cl = i32(cl * 3 + b[q])
            elif flags & consts.JOINT_STEREO:
                for q in range(0, sample_count * 2, 2):
                    r = i32(b[q + 1] - (b[q] >> 1))
                    lft = i32(b[q] + r)
                    if cabs(lft) > mute_limit or cabs(r) > mute_limit:
                        break
                    cl = i32(i32(cl * 3 + lft) * 3 + r)
            else:
                for q in range(0, sample_count * 2, 2):
                    if cabs(b[q]) > mute_limit or cabs(b[q + 1]) > mute_limit:
                        break
                    cl = i32(i32(cl * 3 + b[q]) * 3 + b[q + 1])
            return cl

        crc = _replay_lossy_crc(buf_lossy)

    if i != sample_count:
        buf = [0] * nvals
        mute_error = True
        i = sample_count

    crc_x = fixup_samples(st, buf, i, wvx, crc_x)

    if flags & consts.FALSE_STEREO:
        out = np.zeros((sample_count, 2), np.int32)
        mono_vals = np.asarray(buf[:sample_count], np.int64).astype(np.int32)
        out[:, 0] = mono_vals
        out[:, 1] = mono_vals
    elif flags & consts.MONO_FLAG:
        out = np.asarray(buf, np.int64).astype(np.int32).reshape(-1, 1)
    else:
        out = np.asarray(buf, np.int64).astype(np.int32).reshape(-1, 2)

    crc_error = (crc != hdr.crc or
                 ((flags & consts.FLOAT_DATA) == 0 and wvx is not None
                  and crc_x != st.crc_mvx) or
                 (has_wvc and st.wvc_crc is not None
                  and crc_wvc != st.wvc_crc))
    return BlockResult(out, crc, crc_x, mute_error, crc_error,
                       crc_wvc=crc_wvc, wvc_applied=has_wvc)


def decode_block(st: BlockState) -> BlockResult:
    """Decode a block (PCM or DSD) to its output samples."""
    if st.flags & consts.DSD_FLAG:
        from .dsd_oracle import unpack_dsd_samples
        return unpack_dsd_samples(st)
    return unpack_samples(st)
