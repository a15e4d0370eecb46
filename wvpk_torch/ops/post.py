"""Post-processing of decorrelated samples (port of wvpk/ops/post.py,
integer arms): joint-stereo undo, mute detection, block CRC, fixup.

The CRC is the affine recurrence crc' = 3*crc + x (a stereo pair folds to
crc' = 9*crc + 3*l + r), run here as a plain loop over samples that stops
per lane at its first muted sample: the mute-truncated partial CRC of
UnpackUtils.cs:609-646. Float restore (FloatUtils.cs) and the hybrid clip
wait for the hybrid slice.
"""

from __future__ import annotations

import torch

from .bitio import wrap32

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


def mask_muted(out, nsamples, broke, first_bad):
    """The decoder's concealment: a lane that hit EOF (`broke`) or a
    sample past its mute limit outputs zeros. Returns (out, mute)."""
    mute = broke | (first_bad < nsamples)
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


def fixup(out, shift, int32_zod, *, int32_expand: bool):
    """Integer arms of fixup_samples (UnpackUtils.cs:1251-1404).

    out: (T, L, C) int32; shift (L,) the host-adjusted shift;
    int32_zod (L, 3) zeros/ones/dups for the INT32_DATA re-expansion
    (UnpackUtils.cs:1316-1343), applied when `int32_expand`.
    """
    v = out.to(I64)
    if int32_expand:
        zeros, ones, dups = (int32_zod[:, i].to(I64)[None, :, None]
                             for i in range(3))
        vz = wrap32(v << (zeros & 31))
        vo = wrap32(((v + 1) << (ones & 31)) - 1)
        vd = wrap32(((v + (v & 1)) << (dups & 31)) - (v & 1))
        v = torch.where(zeros != 0, vz,
                        torch.where(ones != 0, vo,
                                    torch.where(dups != 0, vd, v)))
    sh = (shift.to(I64) & 0x1F)[None, :, None]
    return wrap32(v << sh).to(torch.int32)
