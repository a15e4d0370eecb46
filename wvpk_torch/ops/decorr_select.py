"""Decorrelation + post dispatch by tensor device (port of
wvpk/ops/decorr_select.py::decorr_post_any).

CPU tensors take the plain PyTorch versions (decorr.py), CUDA tensors the
kernel (decorr_cuda.py). There is no option and no fallback between them.
The TPU compile specialisations of the JAX version (`static_terms`,
`chain_segments`) have no counterpart: the kernel takes each lane's term
chain at run time.
"""

from __future__ import annotations

from .decorr import decorr_post, decorr_post_wvc
from .decorr_cuda import decorr_post_cuda, decorr_post_wvc_cuda
from .post import mask_muted


def _pick(t, cuda_fn, plain_fn):
    if t.is_cuda:
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"no decorrelation for device {t.device}")


def decorr_post_any(residuals, terms, deltas, w0_a, w0_b, hist0_a,
                    hist0_b, num_terms, nsamples, joint, mute_limit,
                    broke, *, mono: bool):
    """Decorrelation + joint-stereo undo + mute check + CRC in one step.

    Returns (out, crc, mute) with joint_mute_crc's exact contract.
    """
    fn = _pick(residuals, decorr_post_cuda, decorr_post)
    out, crc, first_bad = fn(residuals, terms, deltas, w0_a, w0_b, hist0_a,
                             hist0_b, num_terms, nsamples, joint,
                             mute_limit, mono=mono)
    out, mute = mask_muted(out, nsamples, broke, first_bad)
    return out, crc, mute


def decorr_post_wvc_any(residuals, corr, terms, deltas, w0_a, w0_b,
                        hist0_a, hist0_b, num_terms, nsamples, joint,
                        mute_limit, broke, *, mono: bool):
    """The hybrid-lossless variant: the corrections `corr` add after the
    chain. Returns (out, crc, crc_wvc, mute): the exact samples masked for
    mute, the lossy samples' CRC (wv header), the exact samples' CRC (wvc
    header) and the mute flag of the exact samples."""
    fn = _pick(residuals, decorr_post_wvc_cuda, decorr_post_wvc)
    out, crc, crc_wvc, first_bad = fn(
        residuals, corr, terms, deltas, w0_a, w0_b, hist0_a, hist0_b,
        num_terms, nsamples, joint, mute_limit, mono=mono)
    out, mute = mask_muted(out, nsamples, broke, first_bad)
    return out, crc, crc_wvc, mute
