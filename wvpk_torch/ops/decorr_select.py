"""Decorrelation + post dispatch by tensor device (port of
wvpk/ops/decorr_select.py::decorr_post_any).

CPU tensors take the plain PyTorch version (decorr.py::decorr_post), CUDA
tensors the kernel (decorr_cuda.py). There is no option and no fallback
between them. The TPU compile specialisations of the JAX version
(`static_terms`, `chain_segments`) have no counterpart: the kernel takes
each lane's term chain at run time.
"""

from __future__ import annotations

from .decorr import decorr_post
from .decorr_cuda import decorr_post_cuda
from .post import mask_muted


def decorr_post_any(residuals, terms, deltas, w0_a, w0_b, hist0_a,
                    hist0_b, num_terms, nsamples, joint, mute_limit,
                    broke, *, mono: bool):
    """Decorrelation + joint-stereo undo + mute check + CRC in one step.

    Returns (out, crc, mute) with joint_mute_crc's exact contract.
    """
    if residuals.is_cuda:
        fn = decorr_post_cuda
    elif residuals.device.type == "cpu":
        fn = decorr_post
    else:
        raise ValueError(f"no decorrelation for device {residuals.device}")
    out, crc, first_bad = fn(residuals, terms, deltas, w0_a, w0_b, hist0_a,
                             hist0_b, num_terms, nsamples, joint,
                             mute_limit, mono=mono)
    out, mute = mask_muted(out, nsamples, broke, first_bad)
    return out, crc, mute
