"""Plain PyTorch entropy word decoder, lossless and hybrid profiles (port of
wvpk/ops/entropy.py::entropy_decode and ::wvc_corrections).

A Python loop over samples, vectorised over lanes, int64-exact: every
step decodes one word per lane for mono buckets and a full stereo pair
(channel A then B) for stereo buckets. It mirrors the reference's
get_words (WordsUtils.cs:272-511): zero-run escapes, unary ones_count with
the holding_one/holding_zero carry, the LIMIT_ONES escape, median
intervals and read_code. The hybrid profile adds the error limit
(update_error_limit, WordsUtils.cs:195-261) before each channel-A word,
the error-limited binary search for the value and, with HYBRID_BITRATE,
the slow_level recurrence. Lanes branch through masks; the rare paths
(zero runs, escapes) run only when some lane takes them, and the search
stops once no lane still narrows its interval.

`wvc_corrections` reads a hybrid-lossless correction stream: one
minimal-binary code per word over the interval the search narrowed.

These are the plain versions of the CUDA kernels in csrc/entropy.cu and
csrc/wvc.cu, and the CPU path of `entropy_select`.
"""

from __future__ import annotations

import torch

from .. import consts
from .bitio import bit_length64, bits_of, exp2s_v, make_windows, \
    mylog2_v, peek, trailing_ones, wrap32

LIMIT_ONES = consts.LIMIT_ONES
SLO, SLS = consts.SLO, consts.SLS
I64 = torch.int64


class _LaneState:
    """Per-lane decoder state, updated in place word by word."""

    def __init__(self, med0: torch.Tensor, slow0, acc0, delta0):
        L, dev = med0.shape[0], med0.device

        def state2(init):
            if init is None:
                return torch.zeros((L, 2), dtype=I64, device=dev)
            return init.to(I64).clone()

        self.bitpos = torch.zeros(L, dtype=I64, device=dev)
        self.med = med0.to(I64).clone()            # (L, 2, 3)
        self.slow, self.acc, self.delta = (state2(slow0), state2(acc0),
                                           state2(delta0))
        self.errlim = state2(None)
        self.h1 = torch.zeros(L, dtype=torch.bool, device=dev)
        self.h0 = torch.zeros(L, dtype=torch.bool, device=dev)
        self.zacc = torch.zeros(L, dtype=I64, device=dev)
        self.done = torch.zeros(L, dtype=torch.bool, device=dev)
        self.ndec = torch.zeros(L, dtype=torch.int32, device=dev)


def _slow_decay(slow):
    return slow - ((slow + SLO) >> SLS)


def _gamma(windows, bitpos):
    """WavPack's Elias-gamma read at `bitpos`: (value, bits consumed,
    EOF break); used for zero-run lengths and LIMIT_ONES escapes."""
    cbits = torch.clamp(trailing_ones(peek(windows, bitpos)), max=33)
    data = bits_of(peek(windows, bitpos + cbits + 1), cbits - 1)
    top = torch.ones_like(cbits) << torch.clamp(cbits - 1, 0, 62)
    value = torch.where(cbits < 2, cbits, data | top)
    consume = torch.where(cbits < 2, cbits + 1, 2 * cbits)
    return value, consume, cbits >= 33


def _read_code(win, maxcode):
    """read_code (WordsUtils.cs:546-570) from the window: (code, bits
    consumed). C# `1 << bitcount` is an int shift (mod-32),
    WordsUtils.cs:549."""
    bitcount = torch.where(maxcode > 0, bit_length64(maxcode), 0)
    extras = wrap32(torch.ones_like(bitcount) << (bitcount & 31)) \
        - maxcode - 1
    code0 = bits_of(win, bitcount - 1)
    need_extra = (bitcount > 0) & (code0 >= extras)
    extra_bit = (win >> torch.clamp(bitcount - 1, 0, 62)) & 1
    code = torch.where(need_extra, (code0 << 1) - extras + extra_bit, code0)
    consume = torch.where(bitcount == 0, 0, bitcount - 1 + need_extra.to(I64))
    return code, consume


def _update_error_limit(slow, acc, delta, errlim, mask, mono: bool,
                        hybrid_bitrate: bool, hybrid_balance: bool):
    """update_error_limit (WordsUtils.cs:195-261) for the lanes in
    `mask`: the bitrate accumulators advance by delta and the error limits
    follow them (and, with HYBRID_BITRATE, the slow levels). slow, acc,
    delta and errlim are (L, 2) int64; returns the new (acc, errlim)
    (mono: channel 1 unchanged)."""
    acc_new = acc + delta
    bitrate = wrap32(acc_new >> 16)
    chans = 1 if mono else 2
    slow_log = (slow + SLO) >> SLS
    br = [bitrate[:, c] for c in range(chans)]
    if hybrid_bitrate and hybrid_balance and not mono:
        balance = (slow_log[:, 1] - slow_log[:, 0] + br[1] + 1) >> 1
        hi = balance > br[0]
        lo = (-balance) > br[0]
        br = [torch.where(hi, 0, torch.where(lo, br[0] * 2, br[0] - balance)),
              torch.where(hi, br[0] * 2,
                          torch.where(lo, 0, br[0] + balance))]
    err = []
    for c in range(chans):
        if hybrid_bitrate:
            d = slow_log[:, c] - br[c]
            err.append(torch.where(d > -0x100, exp2s_v(d + 0x100), 0))
        else:
            err.append(exp2s_v(br[c]))
    m = mask[:, None]
    if mono:
        m = m & (torch.arange(2, device=mask.device) == 0)[None, :]
        err.append(errlim[:, 1])
    return (torch.where(m, acc_new, acc),
            torch.where(m, torch.stack(err, dim=1), errlim))


def _search(win, low, high, err, go):
    """The error-limited binary search (WordsUtils.cs:476-507), at most 32
    steps: each step halves [lo, hi] by one stream bit while hi - lo
    passes the error limit. A lane that stops never changes again, so the
    loop ends once no lane in `go` still narrows. Returns (lo, hi, mid,
    bits used)."""
    lo, hi = low, high
    mid = (high + low + 1) >> 1
    used = torch.zeros_like(low)
    for _ in range(32):
        go = go & ((hi - lo) > err)
        if not bool(go.any()):
            break
        bit = ((win >> used) & 1) > 0
        lo = torch.where(go & bit, mid, lo)
        hi = torch.where(go & ~bit, mid - 1, hi)
        mid = torch.where(go, (hi + lo + 1) >> 1, mid)
        used = used + go.to(I64)
    return lo, hi, mid, used


def _decode_word(st: _LaneState, c: int, active, windows, *, mono: bool,
                 hybrid: bool, hybrid_bitrate: bool, hybrid_balance: bool,
                 wvc: bool):
    """One get_words iteration for channel `c` on every lane. Returns the
    residual, and with `wvc` the narrowed interval's (maxcode, base)."""
    med = st.med
    false = torch.zeros_like(active)

    # ---- zero-run branch (WordsUtils.cs:304-352) ----
    zcond = (active & ((med[:, 0, 0] & ~1) == 0)
             & ((med[:, 1, 0] & ~1) == 0) & ~st.h1 & ~st.h0)
    emit_zero = gbreak = false
    if zcond.any():
        in_run = zcond & (st.zacc > 0)
        zacc = torch.where(in_run, st.zacc - 1, st.zacc)
        consumed_zero = in_run & (zacc > 0)
        start = zcond & (st.zacc == 0)
        run_started = false
        if start.any():
            z, gconsume, gb = _gamma(windows, st.bitpos)
            gbreak = start & gb
            do_gamma = start & ~gbreak
            st.bitpos = torch.where(do_gamma, st.bitpos + gconsume,
                                    st.bitpos)
            run_started = do_gamma & (z > 0)
            zacc = torch.where(run_started, z, zacc)
            st.med = med = med.masked_fill(run_started[:, None, None], 0)
        st.zacc = zacc
        emit_zero = consumed_zero | run_started
        if hybrid_bitrate:
            st.slow[:, c] = torch.where(emit_zero, _slow_decay(st.slow[:, c]),
                                        st.slow[:, c])
    normal = active & ~gbreak & ~emit_zero

    # ---- unary ones_count with holding carry (WordsUtils.cs:354-428) ----
    use_h0 = normal & st.h0
    read = normal & ~st.h0
    t_u = trailing_ones(peek(windows, st.bitpos))
    esc = t_u == LIMIT_ONES
    ubreak = read & (t_u >= LIMIT_ONES + 1)
    raw, consume_u, ebreak = t_u, t_u + 1, false
    if (esc & read).any():
        ev, econsume, eb = _gamma(windows, st.bitpos + 17)
        ebreak = read & esc & eb
        raw = torch.where(esc, ev + LIMIT_ONES, t_u)
        consume_u = torch.where(esc, 17 + econsume, t_u + 1)
    broke = gbreak | ubreak | ebreak
    ok_read = read & ~broke
    st.bitpos = torch.where(ok_read, st.bitpos + consume_u, st.bitpos)
    oc = torch.where(use_h0, 0, (raw >> 1) + st.h1.to(I64))
    h1_read = (raw & 1) > 0
    st.h1 = torch.where(ok_read, h1_read, st.h1 & ~use_h0)
    st.h0 = torch.where(ok_read, ~h1_read, st.h0 & ~use_h0)
    code_mask = normal & ~broke

    # ---- hybrid error limit (WordsUtils.cs:430-431): before channel-A
    # words, and every word in mono ----
    if hybrid and c == 0:
        st.acc, st.errlim = _update_error_limit(
            st.slow, st.acc, st.delta, st.errlim, code_mask, mono,
            hybrid_bitrate, hybrid_balance)

    # ---- median interval (WordsUtils.cs:433-475) ----
    m0, m1, m2 = med[:, c, 0], med[:, c, 1], med[:, c, 2]
    g0, g1, g2 = (m0 >> 4) + 1, (m1 >> 4) + 1, (m2 >> 4) + 1
    oc0, oc1, oc2 = oc == 0, oc == 1, oc == 2
    low = torch.where(oc0, 0, torch.where(
        oc1, g0, torch.where(oc2, g0 + g1, g0 + g1 + (oc - 2) * g2)))
    width = torch.where(oc0, g0, torch.where(oc1, g1, g2))
    m0n = wrap32(torch.where(oc0, m0 - ((m0 + (consts.DIV0 - 2)) >> 7) * 2,
                             m0 + ((m0 + consts.DIV0) >> 7) * 5))
    m1n = torch.where(oc0, m1, wrap32(torch.where(
        oc1, m1 - ((m1 + (consts.DIV1 - 2)) >> 6) * 2,
        m1 + ((m1 + consts.DIV1) >> 6) * 5)))
    m2n = torch.where(oc0 | oc1, m2, wrap32(torch.where(
        oc2, m2 - ((m2 + (consts.DIV2 - 2)) >> 5) * 2,
        m2 + ((m2 + consts.DIV2) >> 5) * 5)))
    med_c = torch.where(code_mask[:, None],
                        torch.stack([m0n, m1n, m2n], dim=1), med[:, c])
    st.med = torch.stack([med_c, med[:, 1]] if c == 0
                         else [med[:, 0], med_c], dim=1)

    # ---- value: read_code (WordsUtils.cs:546-570), or the hybrid search
    # where the error limit is not 0, and the sign bit ----
    win_v = peek(windows, st.bitpos)
    code, consume_v = _read_code(win_v, width - 1)
    mid = low + code
    mc_out = base_out = None
    if hybrid:
        err = st.errlim[:, c]
        searched = code_mask & (err != 0)
        lo, hi, mid_s, used = _search(win_v, low, low + width - 1, err,
                                      searched)
        mid = torch.where(searched, mid_s, mid)
        consume_v = torch.where(searched, used, consume_v)
        if wvc:
            mc_out = torch.where(searched, hi - lo, 0).to(torch.int32)
            base_out = torch.where(searched, lo - mid_s, 0).to(torch.int32)
    sign = ((win_v >> torch.clamp(consume_v, 0, 62)) & 1) > 0
    st.bitpos = torch.where(code_mask, st.bitpos + consume_v + 1, st.bitpos)
    value = wrap32(torch.where(sign, ~mid, mid))
    if hybrid_bitrate:
        st.slow[:, c] = torch.where(
            code_mask, _slow_decay(st.slow[:, c]) + mylog2_v(mid),
            st.slow[:, c])

    st.done = st.done | broke
    st.ndec = st.ndec + (emit_zero | code_mask).to(torch.int32)
    out = torch.where(code_mask, value, 0).to(torch.int32)
    if wvc:
        zero = torch.zeros_like(out)
        return out, (zero if mc_out is None else mc_out,
                     zero if base_out is None else base_out)
    return out, None


def entropy_decode(words, nwords_lane, med0, slow0=None, acc0=None,
                   delta0=None, *, mono: bool, nsteps: int,
                   hybrid: bool = False, hybrid_bitrate: bool = False,
                   hybrid_balance: bool = False, wvc: bool = False):
    """Decode up to `nsteps` residual words per lane.

    words:       (L, W) int32 staged bitstreams (uint32 bit patterns)
    nwords_lane: (L,)   int32 words to decode per lane (nsamples * channels)
    med0:        (L, 2, 3) int64 initial medians
    slow0/acc0/delta0: (L, 2) int64 hybrid state (read only by the hybrid
    profile, which needs them)
    Returns (residuals (T, L, C) int32 with T = nsteps // C, broke (L,)
    bool, ndec (L,) int32 words decoded); words past a lane's count or
    after its EOF break are 0.

    wvc=True (hybrid only) also returns, per word, the narrowed
    interval's `maxcode = hi - lo` and `base = lo - mid` (T, L, C) int32,
    0 where a word carries no correction code: (residuals, maxcode, base,
    broke, ndec).
    """
    if wvc and not hybrid:
        raise ValueError("wvc outputs need the hybrid profile")
    if hybrid and (slow0 is None or acc0 is None or delta0 is None):
        raise ValueError("the hybrid profile needs slow0, acc0 and delta0")
    C = 1 if mono else 2
    T = nsteps // C
    L = words.shape[0]
    dev = words.device
    out = torch.zeros((T, L, C), dtype=torch.int32, device=dev)
    if wvc:
        mc = torch.zeros_like(out)
        base = torch.zeros_like(out)
    st = _LaneState(med0, slow0, acc0, delta0)
    windows = make_windows(words)
    nsamples = nwords_lane.to(I64) // C
    nscan = min(T, int(nsamples.max())) if L else 0
    kw = dict(mono=mono, hybrid=hybrid, hybrid_bitrate=hybrid_bitrate,
              hybrid_balance=hybrid_balance, wvc=wvc)
    for t in range(nscan):
        active = nsamples > t
        for c in range(C):
            res, interval = _decode_word(st, c, active & ~st.done, windows,
                                         **kw)
            out[t, :, c] = res
            if wvc:
                mc[t, :, c], base[t, :, c] = interval
    if wvc:
        return out, mc, base, st.done, st.ndec
    return out, st.done, st.ndec


def wvc_corrections(wvc_words, maxcode, base, residuals):
    """Hybrid-lossless correction-stream decode (libwavpack's wvc
    semantics; the reference parses the stream at UnpackUtils.cs:93-108
    but never reads it).

    Each word with maxcode > 0 reads one minimal-binary code (read_code
    over `maxcode`) from the lane's correction bitstream; the correction
    `residual_exact - residual_lossy` is base + code, negated where the
    lossy residual is negative. Corrections add after the decorrelation
    chain, with int32 wrap.

    wvc_words: (L, W) int32 staged correction streams; maxcode, base,
    residuals: (T, L, C) int32. Returns corr (T, L, C) int32.
    """
    windows = make_windows(wvc_words)
    T, L, C = maxcode.shape
    corr = torch.zeros_like(maxcode)
    bitpos = torch.zeros(L, dtype=I64, device=maxcode.device)
    for t in range(T):
        for c in range(C):
            mc = maxcode[t, :, c].to(I64)
            code, consume = _read_code(peek(windows, bitpos), mc)
            mag = base[t, :, c].to(I64) + code
            val = torch.where(residuals[t, :, c] < 0, -mag, mag)
            corr[t, :, c] = torch.where(mc > 0, val, 0).to(torch.int32)
            bitpos = bitpos + consume
    return corr
