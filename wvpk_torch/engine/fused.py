"""Fused bucket decode: entropy -> decorrelation with joint/mute/CRC ->
fixup -> byte pack (port of wvpk/engine/fused.py, lossless path).

There is no jit: each step runs eagerly on the bucket's device, the CUDA
kernels on "cuda" and their plain versions on "cpu". The blob helpers move
a bucket's ~15 per-lane arrays to the device as ONE packed int32 buffer
and unpack it there, so a bucket pays one host-to-device copy.
"""

from __future__ import annotations

import numpy as np
import torch

from wvpk import consts

from ..ops.decorr_select import decorr_post_any
from ..ops.entropy_select import entropy_decode_any
from ..ops.pack import pack_samples
from ..ops.post import fixup


def fused_decode(words, nwords_lane, nsamples, med, terms, deltas16, wa,
                 wb, hist_a, hist_b, num_terms, joint, mute_limit, shift,
                 int32_zod, *, mono: bool, int32_expand: bool, nsteps: int):
    """Decode one bucket. Returns (out (T, L, C) int32, crc (L,) int32,
    mute (L,) bool)."""
    residuals, broke, _ndec = entropy_decode_any(
        words, nwords_lane, med, mono=mono, nsteps=nsteps)
    out, crc, mute = decorr_post_any(
        residuals, terms, deltas16, wa, wb, hist_a, hist_b, num_terms,
        nsamples, joint, mute_limit, broke, mono=mono)
    out = fixup(out, shift, int32_zod, int32_expand=int32_expand)
    return out, crc, mute


# ---------------------------------------------------------------------------
# blob staging
# ---------------------------------------------------------------------------

# The bucket arrays the lossless decode reads, in blob order; the term
# arrays ship trimmed to the bucket's longest chain and are padded back to
# MAX_NTERMS on the device. The int64 arrays listed in NARROW hold int32
# values and ship as int32.
DEVICE_FIELDS = ("words", "nwords_lane", "nsamples", "med", "terms",
                 "deltas16", "wa", "wb", "hist_a", "hist_b", "num_terms",
                 "joint", "mute_limit", "shift", "int32_zod")
TERM_FIELDS = ("terms", "deltas16", "wa", "wb", "hist_a", "hist_b")
NARROW = frozenset({"med", "hist_a", "hist_b", "mute_limit"})


def build_blob(arrays: dict[str, np.ndarray], narrow=frozenset()
               ) -> tuple[np.ndarray, tuple]:
    """Concatenate host arrays into one flat int32 vector + metas (name,
    offset, size, shape, kind) for the device-side unpack. int64 splits
    into little-endian (lo, hi) int32 pairs, or ships as int32 when its
    name is in `narrow` (values that fit int32); bool widens to int32."""
    parts, metas, off = [], [], 0
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.int64 and name in narrow:
            flat = arr.astype(np.int32).reshape(-1)
            if not (flat.astype(np.int64) == arr.reshape(-1)).all():
                raise ValueError(f"blob array {name} does not fit int32")
            kind = "int64_narrow"
        elif arr.dtype == np.int64:
            flat = arr.view(np.int32).reshape(-1)
            kind = "int64"
        elif arr.dtype == np.bool_:
            flat = arr.astype(np.int32).reshape(-1)
            kind = "bool"
        elif arr.dtype in (np.uint32, np.int32):
            flat = arr.view(np.int32).reshape(-1)
            kind = "int32"
        else:
            raise ValueError(f"blob array {name}: unsupported {arr.dtype}")
        parts.append(flat)
        metas.append((name, off, flat.size,
                      tuple(int(s) for s in arr.shape), kind))
        off += flat.size
    return np.concatenate(parts), tuple(metas)


def unpack_blob(blob: torch.Tensor, metas) -> dict[str, torch.Tensor]:
    out = {}
    for name, off, size, shape, kind in metas:
        flat = blob[off:off + size]
        if kind == "int64":
            pair = flat.reshape(shape + (2,)).to(torch.int64)
            a = (pair[..., 1] << 32) | (pair[..., 0] & 0xFFFFFFFF)
        elif kind == "int64_narrow":
            a = flat.reshape(shape).to(torch.int64)
        elif kind == "bool":
            a = (flat != 0).reshape(shape)
        else:
            a = flat.reshape(shape)
        out[name] = a
    return out


def restore_terms(t: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Pad the trimmed term arrays back to MAX_NTERMS passes, the width
    the decorrelation kernel and its plain version take."""
    for name in TERM_FIELDS:
        a = t[name]
        missing = consts.MAX_NTERMS - a.shape[1]
        if missing > 0:
            pad = torch.zeros((a.shape[0], missing) + a.shape[2:],
                              dtype=a.dtype, device=a.device)
            a = torch.cat([a, pad], dim=1)
        t[name] = a.contiguous()
    return t


def deliver(out, crc, mute, pack_bps: int | None):
    """The bucket's two results for the host: the PCM payload (packed
    bytes, or the int32 samples) and a stacked (crc, mute, crc_x) table;
    crc_x is -1, the lossless slice has no wvx stream."""
    payload = out if pack_bps is None else pack_samples(out, bps=pack_bps)
    crcmute = torch.stack([crc.to(torch.int32), mute.to(torch.int32),
                           torch.full_like(crc, -1, dtype=torch.int32)])
    return payload, crcmute
