"""Fused bucket decode: entropy -> decorrelation with joint/mute/CRC ->
[wvx injection] -> fixup -> byte pack (port of wvpk/engine/fused.py).

There is no jit: each step runs eagerly on the bucket's device, the CUDA
kernels on "cuda" and their plain versions on "cpu". Three programs, as
in wvpk: `fused_decode` for lossless, hybrid and float buckets (given
`pack_bps`, for an integer bucket delivered packed, the decorrelation
kernel's store writes the payload with the mute mask, fixup and byte pack
folded in, and no (T, L, C) samples exist on the card),
`fused_decode_wvx` for int32+wvx buckets (the injection runs between
joint/CRC and the final shift, the reference's order,
UnpackUtils.cs:1271-1314) and `fused_decode_wvc` for hybrid buckets with a
paired correction stream. The blob helpers move a bucket's per-lane arrays
to the device as ONE packed int32 buffer and unpack it there, so a bucket
pays one host-to-device copy.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import consts
from ..ops.decorr_select import decorr_packed_any, decorr_post_any, \
    decorr_post_wvc_any
from ..ops.entropy_select import entropy_decode_any, \
    entropy_decode_wvc_any, wvc_corrections_any
from ..ops.pack import pack_samples
from ..ops.post import fixup
from ..ops.post_select import wvx_inject_any


def fused_decode(words, nwords_lane, nsamples, med, slow, acc, delta,
                 terms, deltas16, wa, wb, hist_a, hist_b, num_terms, joint,
                 mute_limit, shift, bytes_stored, float_shift_eff, int32_zod,
                 *, mono: bool, hybrid: bool, hybrid_bitrate: bool,
                 hybrid_balance: bool, is_float: bool, int32_expand: bool,
                 nsteps: int, static_terms: tuple | None = None,
                 chain_segments: tuple | None = None,
                 pack_bps: int | None = None):
    """Decode one bucket. Returns (out (T, L, C) int32, crc (L,) int32,
    mute (L,) bool). `static_terms` / `chain_segments` are the bucket's
    (staging.Bucket): which lanes share a term chain. Given `pack_bps`
    (an integer bucket, not int32-expanded, every lane's bytes_stored
    pack_bps - 1), `out` is the delivered payload in place of the
    samples: (L, W) int32 words, as pack_samples(out, bps=pack_bps)."""
    residuals, broke, _ndec = entropy_decode_any(
        words, nwords_lane, med, slow, acc, delta, mono=mono, nsteps=nsteps,
        hybrid=hybrid, hybrid_bitrate=hybrid_bitrate,
        hybrid_balance=hybrid_balance)
    if pack_bps is not None:
        if is_float or int32_expand:
            raise ValueError("fused_decode: a float or int32-expanded "
                             "bucket has no packed store")
        return decorr_packed_any(
            residuals, terms, deltas16, wa, wb, hist_a, hist_b, num_terms,
            nsamples, joint, mute_limit, broke, shift, mono=mono,
            hybrid=hybrid, bps=pack_bps,
            static_terms=static_terms, chain_segments=chain_segments)
    out, crc, mute = decorr_post_any(
        residuals, terms, deltas16, wa, wb, hist_a, hist_b, num_terms,
        nsamples, joint, mute_limit, broke, mono=mono,
        static_terms=static_terms, chain_segments=chain_segments)
    out = fixup(out, shift, bytes_stored, float_shift_eff, int32_zod,
                is_float=is_float, int32_expand=int32_expand, hybrid=hybrid)
    return out, crc, mute


def fused_decode_wvx(words, nwords_lane, nsamples, med, slow, acc, delta,
                     terms, deltas16, wa, wb, hist_a, hist_b, num_terms,
                     joint, mute_limit, shift, bytes_stored, float_shift_eff,
                     int32_zod, wvx_words, wvx_start_bit, wvx_start_bc,
                     sent_bits, max_width, false_stereo, *, mono: bool,
                     hybrid: bool, hybrid_bitrate: bool,
                     hybrid_balance: bool, has_false_stereo: bool,
                     nsteps: int, static_terms: tuple | None = None,
                     chain_segments: tuple | None = None):
    """Decode one INT32+wvx bucket: the wvx low-bit injection, with its
    own re-expansion and crc_x, runs between joint/CRC and the final
    shift. Returns (out, crc, mute, crc_x (L,) int32)."""
    residuals, broke, _ndec = entropy_decode_any(
        words, nwords_lane, med, slow, acc, delta, mono=mono, nsteps=nsteps,
        hybrid=hybrid, hybrid_bitrate=hybrid_bitrate,
        hybrid_balance=hybrid_balance)
    out, crc, mute = decorr_post_any(
        residuals, terms, deltas16, wa, wb, hist_a, hist_b, num_terms,
        nsamples, joint, mute_limit, broke, mono=mono,
        static_terms=static_terms, chain_segments=chain_segments)
    out, crc_x = wvx_inject_any(
        out, nsamples, wvx_words, wvx_start_bit, wvx_start_bc, sent_bits,
        max_width, int32_zod,
        false_stereo if has_false_stereo else None)
    out = fixup(out, shift, bytes_stored, float_shift_eff, int32_zod,
                is_float=False, int32_expand=False, hybrid=hybrid)
    return out, crc, mute, crc_x


def fused_decode_wvc(words, nwords_lane, nsamples, med, slow, acc, delta,
                     terms, deltas16, wa, wb, hist_a, hist_b, num_terms,
                     joint, mute_limit, shift, bytes_stored, float_shift_eff,
                     int32_zod, wvc_words, *, mono: bool,
                     hybrid_bitrate: bool, hybrid_balance: bool,
                     is_float: bool, int32_expand: bool, nsteps: int,
                     static_terms: tuple | None = None,
                     chain_segments: tuple | None = None):
    """Decode one hybrid bucket with its correction streams, exactly
    (libwavpack's hybrid-lossless semantics; the reference never reads
    the correction stream, WavPackUtils.cs:31).

    The entropy decode also reports each word's narrowed interval, the
    correction scan reads the wvc stream, and the corrections add after
    the decorrelation chain and before the joint undo. Both CRCs come
    back: the wv header's (lossy reconstruction) and the wvc header's
    (exact samples). The float restore follows the block's profile
    (wvpk's fused_decode_wvc skips it). Returns (out, crc, mute,
    crc_wvc)."""
    residuals, mc, base, broke, _ndec = entropy_decode_wvc_any(
        words, nwords_lane, med, slow, acc, delta, mono=mono,
        hybrid_bitrate=hybrid_bitrate, hybrid_balance=hybrid_balance,
        nsteps=nsteps)
    corr = wvc_corrections_any(wvc_words, mc, base, residuals)
    out, crc, crc_wvc, mute = decorr_post_wvc_any(
        residuals, corr, terms, deltas16, wa, wb, hist_a, hist_b, num_terms,
        nsamples, joint, mute_limit, broke, mono=mono,
        static_terms=static_terms, chain_segments=chain_segments)
    out = fixup(out, shift, bytes_stored, float_shift_eff, int32_zod,
                is_float=is_float, int32_expand=int32_expand, hybrid=True)
    return out, crc, mute, crc_wvc


# ---------------------------------------------------------------------------
# blob staging
# ---------------------------------------------------------------------------

# The bucket arrays every decode reads, in blob order, then those of wvx
# and wvc buckets (wvx buckets also ship a per-lane FALSE_STEREO flag). The
# term arrays ship trimmed to the bucket's longest chain and are padded
# back to MAX_NTERMS on the device. The int64 arrays listed in NARROW hold
# int32 values and ship as int32; `acc`, a genuine 64-bit accumulator,
# ships whole.
DEVICE_FIELDS = ("words", "nwords_lane", "nsamples", "med", "slow", "acc",
                 "delta", "terms", "deltas16", "wa", "wb", "hist_a",
                 "hist_b", "num_terms", "joint", "mute_limit", "shift",
                 "bytes_stored", "float_shift_eff", "int32_zod")
WVX_FIELDS = ("wvx_words", "wvx_start_bit", "wvx_start_bc", "sent_bits",
              "max_width")
WVC_FIELDS = ("wvc_words",)
TERM_FIELDS = ("terms", "deltas16", "wa", "wb", "hist_a", "hist_b")
NARROW = frozenset({"med", "slow", "delta", "hist_a", "hist_b",
                    "mute_limit"})


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


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`: on CUDA pinned first and copied without
    blocking, on the CPU the array itself."""
    host = torch.from_numpy(arr)
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


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


def deliver(out, crc, mute, pack_bps: int | None, crc_x=None, crc_wvc=None):
    """The bucket's two results for the host: the PCM payload (`out`
    packed here at `pack_bps`; else `out` as it is: the int32 samples, or
    the payload the decorrelation kernel packed) and a stacked (crc,
    mute, crc_x) table,
    crc_x -1 where the bucket has no wvx stream, with a 4th row crc_wvc
    for a bucket decoded with its correction streams."""
    payload = out if pack_bps is None else pack_samples(out, bps=pack_bps)
    rows = [crc.to(torch.int32), mute.to(torch.int32),
            torch.full_like(crc, -1, dtype=torch.int32) if crc_x is None
            else crc_x.to(torch.int32)]
    if crc_wvc is not None:
        rows.append(crc_wvc.to(torch.int32))
    return payload, torch.stack(rows)
