"""Entropy decode dispatch by tensor device (port of
wvpk/ops/entropy_select.py::entropy_decode_any).

CPU tensors take the plain PyTorch version (entropy.py), CUDA tensors the
kernel (entropy_cuda.py). There is no option and no fallback between them.
"""

from __future__ import annotations

from .entropy import entropy_decode
from .entropy_cuda import entropy_decode_cuda


def entropy_decode_any(words, nwords_lane, med, *, mono: bool, nsteps: int):
    """Returns (residuals (T, L, C) int32, broke (L,) bool, ndec (L,))."""
    if words.is_cuda:
        return entropy_decode_cuda(words, nwords_lane, med, mono=mono,
                                   nsteps=nsteps)
    if words.device.type != "cpu":
        raise ValueError(f"no entropy decoder for device {words.device}")
    return entropy_decode(words, nwords_lane, med, mono=mono, nsteps=nsteps)
