"""Plain PyTorch decorrelation (port of wvpk/ops/decorr.py::decorr_decode).

The reference applies up to 16 adaptive prediction passes one after the
other over the whole buffer (UnpackUtils.cs:553-607). Chaining all passes
per sample is the same computation (a pass only reads strictly-past
outputs of itself, or the current sample's other-channel output for terms
-1/-2), so this is one Python loop over samples with the pass chain inside,
vectorised over lanes. Per term (UnpackUtils.cs:688-1240): the predictor
is (weight * sam + 512) >> 10 in 64 bits, truncated to int32; weights move
by +/-delta on sign agreement, clamped to +/-1024 for the cross-channel
terms -1, -2, -3. Terms may differ lane to lane; each pass computes only
the term classes its lanes use.

`decorr_post` (decorr_decode, then the joint/mute/CRC step) is the plain
version of the CUDA kernel in csrc/decorr.cu.
"""

from __future__ import annotations

import torch

from wvpk import consts

from .bitio import wrap32
from .post import joint_crc

I64 = torch.int64


def _pred(w, sam):
    return (w * sam + 512) >> 10


class _Pass:
    """One pass slot's per-lane constants: its term class masks, write
    masks into the 8-deep history ring, and which classes occur."""

    def __init__(self, term, delta, act, mono: bool):
        dev = term.device
        self.delta = delta.to(I64)
        self.act = act
        self.all_act = bool(act.all())
        self.pos = (term >= 1) & (term <= consts.MAX_TERM)
        self.t17 = term == 17
        self.t18 = term == 18
        shift = (self.t17 | self.t18) & act
        self.n1 = term == -1
        self.n2 = term == -2
        self.n3 = term == -3
        self.neg = (self.n1 | self.n2 | self.n3) & torch.tensor(
            not mono, device=dev)

        def used(mask):
            return bool((mask & act).any())

        self.has_pos, self.has17, self.has18 = (
            used(self.pos), used(self.t17), used(self.t18))
        self.has_n1, self.has_n2, self.has_neg = (
            used(self.n1), used(self.n2), used(self.neg))
        iota8 = torch.arange(8, device=dev)[None, :]
        # ring slot written by a positive term at sample slot m
        pos_act = (self.pos & act)[:, None]
        self.pos_write = [
            (iota8 == ((m + term.to(I64)) & 7)[:, None]) & pos_act
            for m in range(8)] if self.has_pos else None
        self.shift0 = (iota8 == 0) & shift[:, None]
        self.shift1 = (iota8 == 1) & shift[:, None]
        self.has_shift = self.has17 or self.has18
        # -1 and -3 write ob into ring A; -2 and -3 write oa into ring B
        self.neg_a = (iota8 == 0) & ((self.n1 | self.n3) & act)[:, None]
        self.neg_b = (iota8 == 0) & ((self.n2 | self.n3) & act)[:, None]

    def sam(self, ring, m):
        """Predictor input from the history ring at sample slot m."""
        sam = ring[:, 0]
        if self.has_pos:
            sam = torch.where(self.pos, ring[:, m], sam)
        if self.has17:
            sam = torch.where(self.t17, wrap32(2 * ring[:, 0] - ring[:, 1]),
                              sam)
        if self.has18:
            sam = torch.where(self.t18,
                              wrap32(3 * ring[:, 0] - ring[:, 1]) >> 1, sam)
        return sam

    def update(self, w, sam, v):
        do = (sam != 0) & (v != 0)
        neg = (sam ^ v) < 0
        step = torch.where(neg, -self.delta, self.delta)
        w_new = torch.where(do, w + step, w)
        if self.has_neg:
            clamped = torch.where(neg, torch.clamp(w - self.delta, min=-1024),
                                  torch.clamp(w + self.delta, max=1024))
            w_new = torch.where(self.neg & do, clamped, w_new)
        return w_new if self.all_act else torch.where(self.act, w_new, w)

    def write_ring(self, ring, m, o, o_other, neg_mask):
        """The ring after this pass wrote output `o` (and, for the
        cross-channel terms, the other channel's output)."""
        if self.has_pos:
            ring = torch.where(self.pos_write[m], o[:, None], ring)
        if self.has_shift:
            ring = torch.where(self.shift0, o[:, None],
                               torch.where(self.shift1, ring[:, 0:1], ring))
        if self.has_neg:
            ring = torch.where(neg_mask, o_other[:, None], ring)
        return ring


def decorr_decode(residuals, terms, deltas, w0_a, w0_b, hist0_a, hist0_b,
                  num_terms, *, mono: bool):
    """Apply all decorrelation passes.

    residuals: (T, L, C) int32; C = 1 (mono) or 2
    terms/deltas: (L, 16) int32; num_terms (L,) int32
    w0_a/w0_b: (L, 16) int32; hist0_a/hist0_b: (L, 16, 8) int64
    Returns (T, L, C) int32 outputs (same contract as wvpk's).
    """
    T, L, C = residuals.shape
    K = int(num_terms.max()) if L else 0
    passes = [_Pass(terms[:, k], deltas[:, k], num_terms > k, mono)
              for k in range(K)]
    wa = [w0_a[:, k].to(I64) for k in range(K)]
    ring_a = [hist0_a[:, k, :].to(I64) for k in range(K)]
    if not mono:
        wb = [w0_b[:, k].to(I64) for k in range(K)]
        ring_b = [hist0_b[:, k, :].to(I64) for k in range(K)]
    out = torch.empty_like(residuals)
    for t in range(T):
        m = t & 7
        va = residuals[t, :, 0].to(I64)
        vb = None if mono else residuals[t, :, 1].to(I64)
        for k, p in enumerate(passes):
            sam_a = p.sam(ring_a[k], m)
            oa = wrap32(_pred(wa[k], sam_a) + va)
            if mono:
                wa[k] = p.update(wa[k], sam_a, va)
                ring_a[k] = p.write_ring(ring_a[k], m, oa, None, None)
                va = oa if p.all_act else torch.where(p.act, oa, va)
                continue
            sam_b = p.sam(ring_b[k], m)
            if p.has_n1:          # -1: channel A's output feeds B
                sam_b = torch.where(p.n1, oa, sam_b)
            ob = wrap32(_pred(wb[k], sam_b) + vb)
            if p.has_n2:          # -2: B first, its output feeds A
                oa = torch.where(p.n2, wrap32(_pred(wa[k], ob) + va), oa)
                sam_a = torch.where(p.n2, ob, sam_a)
            wa[k] = p.update(wa[k], sam_a, va)
            wb[k] = p.update(wb[k], sam_b, vb)
            ring_a[k] = p.write_ring(ring_a[k], m, oa, ob, p.neg_a)
            ring_b[k] = p.write_ring(ring_b[k], m, ob, oa, p.neg_b)
            if p.all_act:
                va, vb = oa, ob
            else:
                va = torch.where(p.act, oa, va)
                vb = torch.where(p.act, ob, vb)
        out[t, :, 0] = va.to(torch.int32)
        if not mono:
            out[t, :, 1] = vb.to(torch.int32)
    return out


def decorr_post(residuals, terms, deltas, w0_a, w0_b, hist0_a, hist0_b,
                num_terms, nsamples, joint, mute_limit, *, mono: bool):
    """Plain version of the CUDA decorr kernel: decorrelation with the
    joint-stereo undo, mute check and CRC folded after it.

    Returns (out (T, L, C) int32 post-joint and zero past nsamples, not
    masked for mute; crc (L,) int32; first_bad (L,) int32) — see
    post.py::joint_crc.
    """
    dec = decorr_decode(residuals, terms, deltas, w0_a, w0_b, hist0_a,
                        hist0_b, num_terms, mono=mono)
    return joint_crc(dec, nsamples, joint, mute_limit, mono=mono)
