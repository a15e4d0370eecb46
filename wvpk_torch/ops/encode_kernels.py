"""Plain PyTorch encode scans (port of wvpk/ops/encode_kernels.py).

The device encoder's two hot loops, run lane-parallel with blocks as
lanes, each a Python loop over steps vectorised over lanes and int64-exact:

- `decorr_invert_warm`: per sample, peel the decorrelation passes off the
  target values in reverse (the inverse of UnpackUtils.cs:688-1240; the
  cross-channel terms -1/-2 read the partner's value before this pass's
  peel), then run the decode chain forward over the residuals, so the
  carried weights and rings evolve exactly as the decoder's will.
- `entropy_encode_words`: the word automaton of get_words
  (WordsUtils.cs:272-511) run forward: zero runs, unary ones counts with
  the holding carry, LIMIT_ONES escapes, the median intervals and the
  minimal-binary value codes.
- `hybrid_encode_scan`: the lossy scan, peel -> error-limited word coding
  (WordsUtils.cs:195-261 and the decoder's search run in the encode
  direction) -> the chain applied over the reconstructed residuals, fused
  because the reconstruction feeds the decorrelation state. Hybrid blocks
  never start zero runs: where the decoder would read a run length the
  scan writes gamma(0), one 0 bit, and codes the word.

Segments. A step's output bits are five slots, emitted in order: segment
A's four (the flush of the previous word's unary count, or a run's gamma
unary part; the escape gamma's unary part, or the run gamma's value part;
the escape gamma's value part; the flushed word's pended payload) and
segment B (a payload written at once). Each slot is at most 34 bits, held
as a non-negative int64 with its length; wvpk's segment A is the
concatenation of the first four (`ops/encode_pack.py` packs the slots).
The pending word left at the end is the flush the caller appends.

These are the plain versions of the CUDA kernels in csrc/encode_invert.cu,
csrc/encode_words.cu and csrc/encode_hybrid.cu (whose contracts also pack
the slots, `ops/encode_pack.py`), and the CPU path of `encode_select`.
"""

from __future__ import annotations

import torch

from .. import consts
from .bitio import bit_length64, mylog2_v, wrap32
from .decorr import _Chain, _pred
from .entropy import _slow_decay, _update_error_limit

I64 = torch.int64
I32 = torch.int32
LIMIT_ONES = consts.LIMIT_ONES
SLOTS = 5


# ---------------------------------------------------------------------------
# decorrelation inversion
# ---------------------------------------------------------------------------

def _peel(chain: _Chain, m, xa, xb):
    """Peel every pass off one sample's targets, last pass first: pass k
    subtracts its prediction from the values peeled of the passes after
    it. Read-only: the apply half advances the state."""
    va, vb = xa, xb
    for k in reversed(range(len(chain.passes))):
        p = chain.passes[k]
        sam_a = p.sam(chain.ring_a[k], m)
        if chain.mono:
            va2 = wrap32(va - _pred(chain.wa[k], sam_a))
            va = va2 if p.all_act else torch.where(p.act, va2, va)
            continue
        sam_b = p.sam(chain.ring_b[k], m)
        if p.has_n2:              # -2 predicts A from B's value
            sam_a = torch.where(p.n2, vb, sam_a)
        if p.has_n1:              # -1 predicts B from A's value
            sam_b = torch.where(p.n1, va, sam_b)
        va2 = wrap32(va - _pred(chain.wa[k], sam_a))
        vb2 = wrap32(vb - _pred(chain.wb[k], sam_b))
        if p.all_act:
            va, vb = va2, vb2
        else:
            va = torch.where(p.act, va2, va)
            vb = torch.where(p.act, vb2, vb)
    return va, vb


def _state(chain: _Chain, w0a, w0b, h0a, h0b):
    """The chain's carried state in the (L, 16) / (L, 16, 8) int64
    layouts; slots past a lane's chain keep their seeds. Mono returns
    channel A's state twice, as wvpk does."""
    def merge(w0, h0, w, ring):
        w_out, h_out = w0.to(I64).clone(), h0.to(I64).clone()
        for k in range(len(w)):
            w_out[:, k] = w[k]
            h_out[:, k] = ring[k]
        return w_out, h_out

    wa, ha = merge(w0a, h0a, chain.wa, chain.ring_a)
    if chain.mono:
        return wa, wa, ha, ha
    wb, hb = merge(w0b, h0b, chain.wb, chain.ring_b)
    return wa, wb, ha, hb


def decorr_invert_warm(targets, terms, deltas, num_terms, w0a, w0b, h0a, h0b,
                       *, mono: bool, with_state: bool = False,
                       static_terms=None):
    """Peel all passes off joint-domain targets -> entropy residuals.

    targets: (T, L, C) int32; terms/deltas (L, 16) int32; num_terms (L,);
    w0a/w0b (L, 16) and h0a/h0b (L, 16, 8) the seed weights and history
    rings (int32 values). Returns (T, L, C) int32 residuals; with
    with_state also the final (wa, wb, ha, hb) in the seeds' layouts, int64
    (ring slots absolute: position m = T mod 8 is the next sample's).
    `static_terms` chooses a kernel on the card (encode_cuda.
    decorr_invert_cuda) and changes no result: it is taken and ignored.
    """
    T = targets.shape[0]
    chain = _Chain(terms, deltas, w0a, w0b, h0a, h0b, num_terms, mono)
    res = torch.empty_like(targets)
    for t in range(T):
        m = t & 7
        xa = targets[t, :, 0].to(I64)
        xb = None if mono else targets[t, :, 1].to(I64)
        ra, rb = _peel(chain, m, xa, xb)
        res[t, :, 0] = ra.to(I32)
        if not mono:
            res[t, :, 1] = rb.to(I32)
        chain.apply(m, ra, rb)
    if not with_state:
        return res
    return res, _state(chain, w0a, w0b, h0a, h0b)


# ---------------------------------------------------------------------------
# word coding helpers (all values non-negative int64)
# ---------------------------------------------------------------------------

def _ones(n):
    """(1 << n) - 1 for 0 <= n <= 62."""
    return (torch.ones_like(n) << n) - 1


def _gamma(v):
    """The Elias-style escape code of v >= 0 (WordsUtils.cs:321-335) as
    two slots (bits1, len1, bits2, len2): unary(c) then the low c - 1 bits
    of v (top bit implicit); v < 2 is unary alone."""
    c = bit_length64(v)
    small = v < 2
    n1 = torch.where(small, v, c)
    b2 = v & _ones(torch.clamp(c - 1, min=0))
    return (_ones(n1), n1 + 1, torch.where(small, 0, b2),
            torch.where(small, 0, c - 1))


def _flush(do, raw, pbits, pnb):
    """The flush of a pending word as four slots: unary(raw), or
    LIMIT_ONES ones and gamma(raw - LIMIT_ONES), then its pended payload;
    zero-length where `do` is false."""
    esc = raw >= LIMIT_ONES
    gb1, gl1, gb2, gl2 = _gamma(torch.clamp(raw - LIMIT_ONES, min=0))
    n1 = torch.clamp(raw, max=LIMIT_ONES)
    z = torch.zeros_like(raw)
    slots = [(_ones(n1), n1 + 1),
             (torch.where(esc, gb1, z), torch.where(esc, gl1, z)),
             (torch.where(esc, gb2, z), torch.where(esc, gl2, z)),
             (pbits, pnb)]
    return [(torch.where(do, b, z), torch.where(do, n, z)) for b, n in slots]


def _ones_count(av, med):
    """ones_count of |value| av against the pre-update medians (L, 3),
    and the interval [low, high] it selects."""
    g0 = (med[:, 0] >> 4) + 1
    g1 = (med[:, 1] >> 4) + 1
    g2 = torch.clamp((med[:, 2] >> 4) + 1, min=1)
    oc = torch.where(av < g0, 0, torch.where(
        av < g0 + g1, 1, 2 + torch.div(av - g0 - g1, g2,
                                       rounding_mode="floor")))
    low = torch.where(oc == 0, 0, g0 + torch.where(oc == 1, 0,
                                                   g1 + (oc - 2) * g2))
    width = torch.where(oc == 0, g0, torch.where(oc == 1, g1, g2))
    return oc, low, low + width - 1


def _median_update(med, oc):
    """The 5/7-2/7 median adaptation (WordsUtils.cs:433-475) of (L, 3)."""
    m0, m1, m2 = med[:, 0], med[:, 1], med[:, 2]
    m0n = wrap32(torch.where(oc == 0, m0 - ((m0 + (consts.DIV0 - 2)) >> 7) * 2,
                             m0 + ((m0 + consts.DIV0) >> 7) * 5))
    m1n = torch.where(oc <= 0, m1, wrap32(torch.where(
        oc == 1, m1 - ((m1 + (consts.DIV1 - 2)) >> 6) * 2,
        m1 + ((m1 + consts.DIV1) >> 6) * 5)))
    m2n = torch.where(oc <= 1, m2, wrap32(torch.where(
        oc == 2, m2 - ((m2 + (consts.DIV2 - 2)) >> 5) * 2,
        m2 + ((m2 + consts.DIV2) >> 5) * 5)))
    return torch.stack([m0n, m1n, m2n], dim=1)


def _value_code(av, low, high):
    """read_code inverted: the minimal-binary code of av - low over
    [0, high - low] as (bits, length)."""
    code = av - low
    maxcode = high - low
    bitcount = bit_length64(maxcode)
    extras = (torch.ones_like(bitcount) << bitcount) - maxcode - 1
    small = code < extras
    cc = code + extras
    vb = torch.where(small, code, (cc >> 1) | (
        (cc & 1) << torch.clamp(bitcount - 1, min=0)))
    vl = torch.where(bitcount == 0, 0,
                     torch.where(small, bitcount - 1, bitcount))
    return vb, vl


class _Pending:
    """The word automaton's holding state (the previous word's unary
    count and payload wait for the next word's first bit)."""

    def __init__(self, L, dev):
        self.clear = torch.ones(L, dtype=torch.bool, device=dev)
        self.pvalid = torch.zeros(L, dtype=torch.bool, device=dev)
        self.poc = torch.zeros(L, dtype=I64, device=dev)
        self.pbits = torch.zeros(L, dtype=I64, device=dev)
        self.pnb = torch.zeros(L, dtype=I64, device=dev)

    def resolve(self, normal, oc):
        """(fromclear, h0, h1, flush slots) of a coded word."""
        h0 = normal & ~self.clear & (oc == 0)
        h1 = normal & ~self.clear & (oc != 0)
        flush = _flush((h0 | h1) & self.pvalid, 2 * self.poc + h1.to(I64),
                       self.pbits, self.pnb)
        return normal & self.clear, h0, h1, flush

    def advance(self, fromclear, h0, h1, oc, wbits, wnb):
        emit = fromclear | h1
        self.pvalid = emit | (self.pvalid & ~(h0 | h1))
        self.poc = torch.where(emit, oc - h1.to(I64), self.poc)
        self.pbits = torch.where(emit, wbits, self.pbits)
        self.pnb = torch.where(emit, wnb, self.pnb)
        self.clear = h0 | (self.clear & ~emit)

    def tail(self):
        """The final flush (EntropyEncoder.finish: b = 0) as four slots."""
        return _flush(self.pvalid, 2 * self.poc, self.pbits, self.pnb)

    def outputs(self):
        return self.pvalid, self.poc, self.pbits, self.pnb.to(I32)


def _store(bits, lens, w, slots):
    bits[w] = torch.stack([b for b, _ in slots], dim=1)
    lens[w] = torch.stack([n for _, n in slots], dim=1).to(I32)


# ---------------------------------------------------------------------------
# lossless word coding
# ---------------------------------------------------------------------------

def zero_run_lengths(res_words, nvals):
    """zlen[w] = the number of consecutive valid zero words from w on
    (W, L) int64: a reverse cummin of each word's stop index."""
    W = res_words.shape[0]
    iota = torch.arange(W, device=res_words.device)[:, None]
    valid_zero = (res_words == 0) & (iota < nvals.to(I64)[None, :])
    stop = torch.where(valid_zero, W, iota)
    nstop = torch.cummin(stop.flip(0), dim=0).values.flip(0)
    return nstop - iota


def entropy_encode_words(res_words, med0, nvals, *, mono: bool):
    """Encode residual words -> bit slots.

    res_words (W, L) int32, channel-interleaved per sample (stereo);
    med0 (L, 2, 3) int64 quantized, non-negative medians (mono leaves
    channel 1 at 0); nvals (L,) valid word counts. Returns (bits (W, L, 5)
    int64, lens (W, L, 5) int32, pvalid (L,) bool, poc (L,) int64, pbits
    (L,) int64, pnb (L,) int32).
    """
    W, L = res_words.shape
    dev = res_words.device
    bits = torch.zeros((W, L, SLOTS), dtype=I64, device=dev)
    lens = torch.zeros((W, L, SLOTS), dtype=I32, device=dev)
    med = med0.to(I64).clone()
    nv = nvals.to(I64)
    zlen = zero_run_lengths(res_words, nvals)
    zacc = torch.zeros(L, dtype=I64, device=dev)
    pend = _Pending(L, dev)
    zero = torch.zeros(L, dtype=I64, device=dev)
    for w in range(W):
        c = 0 if mono else w & 1
        valid = nv > w
        gate = pend.clear & valid & ((med[:, 0, 0] & ~1) == 0) \
            & ((med[:, 1, 0] & ~1) == 0)
        z1 = gate & (zacc > 0)
        zacc1 = zacc - z1.to(I64)
        midrun = z1 & (zacc1 > 0)
        z2 = gate & (zacc == 0)
        z = torch.where(z2, zlen[w], zero)
        start = z2 & (z > 0)
        zacc = torch.where(start, z, zacc1)
        normal = valid & ~midrun & ~start

        r = res_words[w].to(I64)
        sign = r < 0
        av = torch.where(sign, ~r, r)
        oc, low, high = _ones_count(av, med[:, c])
        fromclear, h0, h1, flush = pend.resolve(normal, oc)
        # segment A: the flush, or (exclusive: z2 needs clear, a flush
        # not) the run length's gamma
        zb1, zl1, zb2, zl2 = _gamma(z)
        slots = [(flush[0][0] + torch.where(z2, zb1, zero),
                  flush[0][1] + torch.where(z2, zl1, zero)),
                 (flush[1][0] + torch.where(z2, zb2, zero),
                  flush[1][1] + torch.where(z2, zl2, zero)),
                 flush[2], flush[3]]

        med[:, c] = torch.where(normal[:, None], _median_update(med[:, c], oc),
                                med[:, c])
        med = med.masked_fill(start[:, None, None], 0)
        vb, vl = _value_code(av, low, high)
        wbits = vb | (sign.to(I64) << vl)
        wnb = vl + 1
        slots.append((torch.where(h0, wbits, zero),
                      torch.where(h0, wnb, zero)))
        _store(bits, lens, w, slots)
        pend.advance(fromclear, h0, h1, oc, wbits, wnb)
    return (bits, lens) + pend.outputs()


# ---------------------------------------------------------------------------
# hybrid (lossy) fused scan
# ---------------------------------------------------------------------------

class _HybridState:
    def __init__(self, med0, slow0, acc0, delta0):
        L, dev = med0.shape[0], med0.device
        self.med = med0.to(I64).clone()                # (L, 2, 3)
        self.slow = slow0.to(I64).clone()              # (L, 2)
        self.acc = acc0.to(I64).clone()
        self.delta = delta0.to(I64)
        self.errlim = torch.zeros((L, 2), dtype=I64, device=dev)
        self.pend = _Pending(L, dev)


def _search(av, low, high, err):
    """The error-limited binary search in the encode direction: while
    high - low exceeds the limit (at most 32 steps) halve the interval
    toward av, one emitted bit a step. Returns (the bits, their count, the
    final midpoint)."""
    lo, hi = low, high
    mid = (high + low + 1) >> 1
    used = torch.zeros_like(low)
    val = torch.zeros_like(low)
    go = err != 0                 # limit 0 takes the lossless code
    for _ in range(32):
        go = go & ((hi - lo) > err)
        if not bool(go.any()):
            break
        bit = av >= mid
        lo = torch.where(go & bit, mid, lo)
        hi = torch.where(go & ~bit, mid - 1, hi)
        mid = torch.where(go, (hi + lo + 1) >> 1, mid)
        val = val | ((go & bit).to(I64) << used)
        used = used + go.to(I64)
    return val, used, mid


def _hybrid_word(s: _HybridState, c: int, r, valid, *, mono: bool,
                 hybrid_bitrate: bool, hybrid_balance: bool):
    """One residual word of channel c under the error limit: returns its
    five slots and the residual the decoder will reconstruct (0 where
    not valid)."""
    zero = torch.zeros_like(r)
    pend = s.pend
    gate = pend.clear & valid & ((s.med[:, 0, 0] & ~1) == 0) \
        & ((s.med[:, 1, 0] & ~1) == 0)
    sign = r < 0
    av = torch.where(sign, ~r, r)
    medc = s.med[:, c]
    oc, low, high = _ones_count(av, medc)
    fromclear, h0, h1, flush = pend.resolve(valid, oc)
    # the run gate writes gamma(0), a single 0 bit (exclusive with a flush)
    slots = [(flush[0][0], flush[0][1] + gate.to(I64))] + flush[1:]

    if c == 0:          # before channel-A words, every word in mono
        s.acc, s.errlim = _update_error_limit(
            s.slow, s.acc, s.delta, s.errlim, valid, mono, hybrid_bitrate,
            hybrid_balance)
    err = s.errlim[:, c]

    vb, vl = _value_code(av, low, high)
    val, used, mid = _search(av, low, high, err)
    lossless = err == 0
    base_bits = torch.where(lossless, vb, val)
    base_len = torch.where(lossless, vl, used)
    wbits = base_bits | (sign.to(I64) << base_len)
    wnb = base_len + 1
    mid_fin = torch.where(lossless, av, mid)
    rhat = torch.where(valid, wrap32(torch.where(sign, ~mid_fin, mid_fin)),
                       zero)

    s.med[:, c] = torch.where(valid[:, None], _median_update(medc, oc), medc)
    if hybrid_bitrate:
        s.slow[:, c] = torch.where(
            valid, _slow_decay(s.slow[:, c]) + mylog2_v(mid_fin), s.slow[:, c])
    slots.append((torch.where(h0, wbits, zero), torch.where(h0, wnb, zero)))
    pend.advance(fromclear, h0, h1, oc, wbits, wnb)
    return slots, rhat


def hybrid_encode_scan(targets, terms, deltas, num_terms, med0, slow0, acc0,
                       delta0, nvals, w0a, w0b, h0a, h0b, *, mono: bool,
                       hybrid_bitrate: bool, hybrid_balance: bool):
    """Fused hybrid (lossy) encode: per sample, peel -> error-limited
    coding of its words -> the chain applied over the reconstructed
    residuals.

    targets (T, L, C) int32 joint domain; med0 (L, 2, 3), slow0, acc0,
    delta0 (L, 2) int64 quantized entropy and hybrid state; nvals (L,)
    valid word counts; seeds as in decorr_invert_warm. Returns (bits
    (W, L, 5), lens (W, L, 5), pvalid, poc, pbits, pnb) as
    entropy_encode_words, W = T * C (stereo words interleaved), plus the
    decoder's reconstruction recon (T, L, C) int32.
    """
    T, L, C = targets.shape
    dev = targets.device
    chain = _Chain(terms, deltas, w0a, w0b, h0a, h0b, num_terms, mono)
    s = _HybridState(med0, slow0, acc0, delta0)
    bits = torch.zeros((T * C, L, SLOTS), dtype=I64, device=dev)
    lens = torch.zeros((T * C, L, SLOTS), dtype=I32, device=dev)
    recon = torch.empty_like(targets)
    nv = nvals.to(I64)
    kw = dict(mono=mono, hybrid_bitrate=hybrid_bitrate,
              hybrid_balance=hybrid_balance)
    for t in range(T):
        m = t & 7
        xa = targets[t, :, 0].to(I64)
        xb = None if mono else targets[t, :, 1].to(I64)
        ra, rb = _peel(chain, m, xa, xb)
        slots, ra = _hybrid_word(s, 0, ra, nv > t * C, **kw)
        _store(bits, lens, t * C, slots)
        if not mono:
            slots, rb = _hybrid_word(s, 1, rb, nv > t * C + 1, **kw)
            _store(bits, lens, t * C + 1, slots)
        oa, ob = chain.apply(m, ra, rb)
        recon[t, :, 0] = oa.to(I32)
        if not mono:
            recon[t, :, 1] = ob.to(I32)
    return (bits, lens) + s.pend.outputs() + (recon,)
