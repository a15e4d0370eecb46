"""Plain PyTorch entropy word decoder, lossless profile (port of the
lossless branch of wvpk/ops/entropy.py::entropy_decode).

A Python loop over samples, vectorised over lanes, int64-exact: every
step decodes one word per lane for mono buckets and a full stereo pair
(channel A then B) for stereo buckets. It mirrors the reference's
get_words (WordsUtils.cs:272-511): zero-run escapes, unary ones_count with
the holding_one/holding_zero carry, the LIMIT_ONES escape, median
intervals and read_code. Lanes branch through masks; the rare paths (zero
runs, escapes) run only when some lane takes them.

This is the plain version of the CUDA kernel in csrc/entropy.cu and the
CPU path of `entropy_select.entropy_decode_any`.
"""

from __future__ import annotations

import torch

from wvpk import consts

from .bitio import bit_length64, bits_of, make_windows, peek, \
    trailing_ones, wrap32

LIMIT_ONES = consts.LIMIT_ONES
I64 = torch.int64


class _LaneState:
    """Per-lane decoder state, updated in place word by word."""

    def __init__(self, med0: torch.Tensor):
        L, dev = med0.shape[0], med0.device
        self.bitpos = torch.zeros(L, dtype=I64, device=dev)
        self.med = med0.to(I64).clone()            # (L, 2, 3)
        self.h1 = torch.zeros(L, dtype=torch.bool, device=dev)
        self.h0 = torch.zeros(L, dtype=torch.bool, device=dev)
        self.zacc = torch.zeros(L, dtype=I64, device=dev)
        self.done = torch.zeros(L, dtype=torch.bool, device=dev)
        self.ndec = torch.zeros(L, dtype=torch.int32, device=dev)


def _gamma(windows, bitpos):
    """WavPack's Elias-gamma read at `bitpos`: (value, bits consumed,
    EOF break); used for zero-run lengths and LIMIT_ONES escapes."""
    cbits = torch.clamp(trailing_ones(peek(windows, bitpos)), max=33)
    data = bits_of(peek(windows, bitpos + cbits + 1), cbits - 1)
    top = torch.ones_like(cbits) << torch.clamp(cbits - 1, 0, 62)
    value = torch.where(cbits < 2, cbits, data | top)
    consume = torch.where(cbits < 2, cbits + 1, 2 * cbits)
    return value, consume, cbits >= 33


def _decode_word(st: _LaneState, c: int, active, windows):
    """One get_words iteration for channel `c` on every lane."""
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

    # ---- value: read_code (WordsUtils.cs:546-570) and the sign bit ----
    win_v = peek(windows, st.bitpos)
    maxcode = width - 1
    bitcount = torch.where(maxcode > 0, bit_length64(maxcode), 0)
    # C# `1 << bitcount` is an int shift (mod-32), WordsUtils.cs:549
    extras = wrap32(torch.ones_like(bitcount) << (bitcount & 31)) \
        - maxcode - 1
    code0 = bits_of(win_v, bitcount - 1)
    need_extra = (bitcount > 0) & (code0 >= extras)
    extra_bit = (win_v >> torch.clamp(bitcount - 1, 0, 62)) & 1
    code = torch.where(need_extra, (code0 << 1) - extras + extra_bit, code0)
    consume_v = torch.where(bitcount == 0, 0,
                            bitcount - 1 + need_extra.to(I64))
    mid = low + code
    sign = ((win_v >> torch.clamp(consume_v, 0, 62)) & 1) > 0
    st.bitpos = torch.where(code_mask, st.bitpos + consume_v + 1, st.bitpos)
    value = wrap32(torch.where(sign, ~mid, mid))

    st.done = st.done | broke
    st.ndec = st.ndec + (emit_zero | code_mask).to(torch.int32)
    return torch.where(code_mask, value, 0).to(torch.int32)


def entropy_decode(words, nwords_lane, med0, *, mono: bool, nsteps: int):
    """Decode up to `nsteps` residual words per lane (lossless blocks).

    words:       (L, W) int32 staged bitstreams (uint32 bit patterns)
    nwords_lane: (L,)   int32 words to decode per lane (nsamples * channels)
    med0:        (L, 2, 3) int64 initial medians
    Returns (residuals (T, L, C) int32 with T = nsteps // C, broke (L,)
    bool, ndec (L,) int32 words decoded); words past a lane's count or
    after its EOF break are 0.
    """
    C = 1 if mono else 2
    T = nsteps // C
    L = words.shape[0]
    out = torch.zeros((T, L, C), dtype=torch.int32, device=words.device)
    st = _LaneState(med0)
    windows = make_windows(words)
    nsamples = nwords_lane.to(I64) // C
    nscan = min(T, int(nsamples.max())) if L else 0
    for t in range(nscan):
        active = nsamples > t
        for c in range(C):
            out[t, :, c] = _decode_word(st, c, active & ~st.done, windows)
    return out, st.done, st.ndec
