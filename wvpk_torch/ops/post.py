"""Post-processing of decorrelated samples (port of wvpk/ops/post.py):
joint-stereo undo, mute detection, block CRC, fixup and the wvx low-bit
injection.

The CRC is the affine recurrence crc' = 3*crc + x (a stereo pair folds to
crc' = 9*crc + 3*l + r), run here as a plain loop over samples that stops
per lane at its first muted sample: the mute-truncated partial CRC of
UnpackUtils.cs:609-646. `fixup` has the integer, float (FloatUtils.cs:
32-56) and hybrid-clip arms; it is elementwise, so it runs as plain
PyTorch on the card too. `wvx_inject` is the plain version of the CUDA
kernel in csrc/wvx.cu.
"""

from __future__ import annotations

import torch

from .bitio import bit_length64, bits_of, make_windows, peek, wrap32

I64 = torch.int64


def _cabs(v):
    """C# unchecked abs on int32 values held in int64."""
    return torch.where(v < 0, wrap32(-v), v)


def joint_crc(decorr_out, nsamples, joint, mute_limit, *, mono: bool):
    """Joint-stereo undo, first out-of-range sample and block CRC: the
    contract of the folded post step of the CUDA decorr kernel.

    decorr_out: (T, L, C) int32; nsamples (L,) int32; joint (L,) bool;
    mute_limit (L,) int64.
    Returns (out (T, L, C) int32 post-joint and zero past nsamples,
    crc (L,) int32 over the samples before first_bad, first_bad (L,)
    int32: the first sample whose magnitude passes mute_limit, or
    nsamples when none does).
    """
    T, L, C = decorr_out.shape
    v = decorr_out.to(I64)
    ns = nsamples.to(I64)
    valid = torch.arange(T, device=v.device)[:, None] < ns[None, :]
    lim = mute_limit.to(I64)[None, :]
    if mono:
        out_l = v[:, :, 0]
        bad = valid & (_cabs(out_l) > lim)
        x, mult = out_l, 3
        outs = out_l[:, :, None]
    else:
        l0, r0 = v[:, :, 0], v[:, :, 1]
        r1 = wrap32(r0 - (l0 >> 1))
        l1 = wrap32(l0 + r1)
        jt = joint.to(torch.bool)[None, :]
        out_l = torch.where(jt, l1, l0)
        out_r = torch.where(jt, r1, r0)
        bad = valid & ((_cabs(out_l) > lim) | (_cabs(out_r) > lim))
        x, mult = out_l * 3 + out_r, 9
        outs = torch.stack([out_l, out_r], dim=2)
    first_bad = torch.where(bad.any(dim=0),
                            bad.to(torch.int32).argmax(dim=0), ns)
    crc = torch.full((L,), 0xFFFFFFFF, dtype=I64, device=v.device)
    for t in range(min(T, int(first_bad.max())) if L else 0):
        crc = torch.where(first_bad > t, (crc * mult + x[t]) & 0xFFFFFFFF,
                          crc)
    outs = torch.where(valid[:, :, None], outs, 0)
    return (outs.to(torch.int32), wrap32(crc).to(torch.int32),
            first_bad.to(torch.int32))


def muted(nsamples, broke, first_bad):
    """The lanes the decoder conceals: those that hit EOF (`broke`) or a
    sample past their mute limit before their sample count."""
    return broke | (first_bad < nsamples)


def mask_muted(out, nsamples, broke, first_bad):
    """The decoder's concealment: a muted lane (`muted`) outputs zeros.
    Returns (out, mute)."""
    mute = muted(nsamples, broke, first_bad)
    return torch.where(mute[None, :, None], 0, out), mute


def joint_mute_crc(decorr_out, nsamples, joint, mute_limit, broke, *,
                   mono: bool):
    """Joint-stereo undo + mute-limit check + per-block CRC.

    Same contract as wvpk/ops/post.py::joint_mute_crc: returns
    (out (T, L, C) int32, crc (L,) int32, mute (L,) bool).
    """
    out, crc, first_bad = joint_crc(decorr_out, nsamples, joint,
                                    mute_limit, mono=mono)
    out, mute = mask_muted(out, nsamples, broke, first_bad)
    return out, crc, mute


def _expand(v, zeros, ones, dups):
    """The INT32_DATA re-expansion (UnpackUtils.cs:1316-1343): zeros,
    ones or dups low bits back onto each value; C# int shifts are
    mod-32."""
    vz = wrap32(v << (zeros & 31))
    vo = wrap32(((v + 1) << (ones & 31)) - 1)
    vd = wrap32(((v + (v & 1)) << (dups & 31)) - (v & 1))
    return torch.where(zeros != 0, vz,
                       torch.where(ones != 0, vo,
                                   torch.where(dups != 0, vd, v)))


def fixup(out, shift, bytes_stored, float_shift_eff, int32_zod, *,
          is_float: bool, int32_expand: bool, hybrid: bool):
    """Elementwise fixup_samples (UnpackUtils.cs:1251-1404).

    out: (T, L, C) int32; shift (L,) the host-adjusted shift;
    bytes_stored (L,) in 0..3; float_shift_eff (L,) the float shift,
    clamped to +/-32 on the host; int32_zod (L, 3) zeros/ones/dups for
    the INT32_DATA re-expansion, applied when `int32_expand` (wvx blocks
    re-expand inside `wvx_inject` instead).
    """
    v = out.to(I64)
    if is_float:
        # FloatUtils.cs:32-56; C# int shifts are mod-32
        sh = float_shift_eff.to(I64)[None, :, None]
        left = wrap32(v << (torch.clamp(sh, 0, 63) & 31))
        right = v >> (torch.clamp(-sh, 0, 63) & 31)
        v = torch.where(sh > 0, left, torch.where(sh < 0, right, v))
        return torch.clamp(v, -8388608, 8388607).to(torch.int32)
    if int32_expand:
        v = _expand(v, *(int32_zod[:, i].to(I64)[None, :, None]
                         for i in range(3)))
    sh = (shift.to(I64) & 0x1F)[None, :, None]
    if not hybrid:
        return wrap32(v << sh).to(torch.int32)
    # the hybrid clip to the stored width (UnpackUtils.cs:1350-1393)
    bs = bytes_stored.to(I64)[None, :, None]
    max_value = torch.where(bs == 0, 127, torch.where(
        bs == 1, 32767, torch.where(bs == 2, 8388607, 0x7FFFFFFF))) >> sh
    # C#: 0x80000000 is uint, so its shift is logical (UnpackUtils.cs:1374)
    min_value = torch.where(
        bs == 3, wrap32(torch.full_like(sh, 0x80000000) >> sh),
        torch.where(bs == 0, -128,
                    torch.where(bs == 1, -32768, -8388608)) >> sh)
    v = torch.where(v < min_value, wrap32(min_value << sh),
                    torch.where(v > max_value, wrap32(max_value << sh),
                                wrap32(v << sh)))
    return v.to(torch.int32)


def wvx_inject(out, nsamples, wvx_words, wvx_start_bit, wvx_start_bc,
               sent_bits, max_width, int32_zod, false_stereo=None):
    """INT32 wvx low-bit injection, re-expansion and crc_x
    (UnpackUtils.cs:1271-1314), a serial scan per lane: how many bits a
    value takes depends on the value. Values run in interleaved memory
    order; crc_x covers the re-expanded values.

    The reference's getbits keeps a bit count `bc` that refills in byte
    steps and returns a window of min(bc, 32) bits, lookahead included,
    masked to sent_bits (mod-32 shift, as in C#); the scan carries `bc`.

    FALSE_STEREO quirk (UnpackUtils.cs:1265): fixup_samples counts
    sample_count * 2 values whenever MONO_FLAG is clear, though a
    FALSE_STEREO block holds only sample_count values at that point (the
    channel duplication at :668-680 runs after fixup). The reference
    therefore injects wvx bits into the zero second half of its buffer
    and folds those values into crc_x; `false_stereo` lanes replicate
    this with a second pass over zeros, which moves only the cursor and
    crc_x.

    out: (T, L, C) int32 post joint/mute; nsamples (L,); wvx_words (L, W)
    int32; wvx_start_bit/bc (L,) initial cursor; sent_bits/max_width
    (L,); int32_zod (L, 3); false_stereo (L,) bool or None.
    Returns (out' (T, L, C) int32, crc_x (L,) int32). This is the plain
    version of the CUDA kernel in csrc/wvx.cu.
    """
    T, L, C = out.shape
    windows = make_windows(wvx_words)
    sb = sent_bits.to(I64)
    mask = (torch.ones_like(sb) << (sb & 31)) - 1
    mw = max_width.to(I64)
    zod = [int32_zod[:, i].to(I64) for i in range(3)]
    ns = nsamples.to(I64)
    state = [wvx_start_bit.to(I64), wvx_start_bc.to(I64),
             torch.full((L,), -1, dtype=I64, device=out.device)]

    def one_value(v, valid):
        bitpos, bc, crc_x = state
        pvalue = torch.where(v < 0, ~v, v)
        width = torch.where(pvalue > 0, bit_length64(pvalue), 0) + sb
        truncated = (mw > 0) & (width > mw)
        btr = torch.where(truncated, sb - (width - mw), sb)
        do_read = valid & (sb > 0) & (~truncated | (btr > 0))
        btr = torch.where(do_read, btr, 0)
        need = torch.clamp(btr - bc, min=0)
        bc_pre = bc + (((need + 7) >> 3) << 3)
        data = bits_of(peek(windows, bitpos), torch.clamp(bc_pre, max=32)) \
            & mask
        injected = wrap32(wrap32(wrap32(v << (btr & 31)) | data)
                          << ((sb - btr) & 31))
        no_read = valid & (sb > 0) & ~do_read
        v1 = torch.where(do_read, injected,
                         torch.where(no_read, wrap32(v << (sb & 31)), v))
        v2 = torch.where(valid, _expand(v1, *zod), v)
        crc1 = wrap32(crc_x * 9 + (v2 & 0xFFFF) * 3 + ((v2 >> 16) & 0xFFFF))
        state[:] = [torch.where(do_read, bitpos + btr, bitpos),
                    torch.where(do_read, bc_pre - btr, bc),
                    torch.where(valid, crc1, crc_x)]
        return v2

    injected = torch.empty_like(out)
    for t in range(T):
        valid = ns > t
        for c in range(C):
            injected[t, :, c] = one_value(out[t, :, c].to(I64), valid)
    if false_stereo is not None:
        zero = torch.zeros(L, dtype=I64, device=out.device)
        for t in range(T):
            one_value(zero, false_stereo & (ns > t))
    return injected, wrap32(state[2]).to(torch.int32)
