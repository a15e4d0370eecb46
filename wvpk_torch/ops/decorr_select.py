"""Decorrelation + post dispatch by tensor device (port of
wvpk/ops/decorr_select.py::decorr_post_any).

CPU tensors take the plain PyTorch versions (decorr.py), CUDA tensors the
kernels (decorr_cuda.py). There is no option and no fallback between them.
`decorr_packed_any` is the route of a bucket whose payload is delivered
packed: on CUDA the kernels' packed store writes it, on the CPU the plain
chain (decorr_post, mask_muted, fixup, pack_samples) makes it.
As in the JAX version, `static_terms` (a uniform bucket's chain) and
`chain_segments` (the lane runs of a mixed-chain bucket, from
engine/staging.py) choose the kernel instantiation compiled for each
run's chain; the plain versions compute the same function and ignore
them.
"""

from __future__ import annotations

from .decorr import Pack, decorr_post, decorr_post_packed, decorr_post_wvc
from .decorr_cuda import decorr_post_cuda, decorr_post_wvc_cuda
from .post import mask_muted, muted


def _on_cuda(t) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no decorrelation for device {t.device}")


def decorr_post_any(residuals, terms, deltas, w0_a, w0_b, hist0_a,
                    hist0_b, num_terms, nsamples, joint, mute_limit,
                    broke, *, mono: bool, static_terms: tuple | None = None,
                    chain_segments: tuple | None = None):
    """Decorrelation + joint-stereo undo + mute check + CRC in one step.

    Returns (out, crc, mute) with joint_mute_crc's exact contract.
    """
    args = (residuals, terms, deltas, w0_a, w0_b, hist0_a, hist0_b,
            num_terms, nsamples, joint, mute_limit)
    if _on_cuda(residuals):
        out, crc, first_bad = decorr_post_cuda(
            *args, mono=mono, static_terms=static_terms,
            chain_segments=chain_segments)
    else:
        out, crc, first_bad = decorr_post(*args, mono=mono)
    out, mute = mask_muted(out, nsamples, broke, first_bad)
    return out, crc, mute


def decorr_packed_any(residuals, terms, deltas, w0_a, w0_b, hist0_a,
                      hist0_b, num_terms, nsamples, joint, mute_limit, broke,
                      shift, *, mono: bool, hybrid: bool, bps: int,
                      static_terms: tuple | None = None,
                      chain_segments: tuple | None = None):
    """decorr_post_any, then fixup's integer arm (`hybrid`: with its clip)
    and pack_samples at `bps` bytes a sample, in one step: every lane
    stores bps bytes a sample (bytes_stored bps - 1). Returns (payload (L, W) int32 words of
    packed PCM, crc (L,) int32, mute (L,) bool)."""
    args = (residuals, terms, deltas, w0_a, w0_b, hist0_a, hist0_b,
            num_terms, nsamples, joint, mute_limit)
    pack = Pack(broke, shift, bps, hybrid)
    if _on_cuda(residuals):
        payload, crc, first_bad = decorr_post_cuda(
            *args, mono=mono, static_terms=static_terms,
            chain_segments=chain_segments, pack=pack)
    else:
        payload, crc, first_bad = decorr_post_packed(*args, mono=mono,
                                                     pack=pack)
    return payload, crc, muted(nsamples, broke, first_bad)


def decorr_post_wvc_any(residuals, corr, terms, deltas, w0_a, w0_b,
                        hist0_a, hist0_b, num_terms, nsamples, joint,
                        mute_limit, broke, *, mono: bool,
                        static_terms: tuple | None = None,
                        chain_segments: tuple | None = None):
    """The hybrid-lossless variant: the corrections `corr` add after the
    chain. Returns (out, crc, crc_wvc, mute): the exact samples masked for
    mute, the lossy samples' CRC (wv header), the exact samples' CRC (wvc
    header) and the mute flag of the exact samples."""
    args = (residuals, corr, terms, deltas, w0_a, w0_b, hist0_a, hist0_b,
            num_terms, nsamples, joint, mute_limit)
    if _on_cuda(residuals):
        out, crc, crc_wvc, first_bad = decorr_post_wvc_cuda(
            *args, mono=mono, static_terms=static_terms,
            chain_segments=chain_segments)
    else:
        out, crc, crc_wvc, first_bad = decorr_post_wvc(*args, mono=mono)
    out, mute = mask_muted(out, nsamples, broke, first_bad)
    return out, crc, crc_wvc, mute
