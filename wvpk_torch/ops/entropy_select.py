"""Entropy decode dispatch by tensor device (port of
wvpk/ops/entropy_select.py).

CPU tensors take the plain PyTorch versions (entropy.py), CUDA tensors the
kernels (entropy_cuda.py, wvc_cuda.py). There is no option and no fallback
between them.
"""

from __future__ import annotations

from .entropy import entropy_decode, wvc_corrections
from .entropy_cuda import entropy_decode_cuda, entropy_decode_wvc_cuda
from .wvc_cuda import wvc_corrections_cuda


def _on_cuda(t) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no entropy decoder for device {t.device}")
    return False


def entropy_decode_any(words, nwords_lane, med, slow=None, acc=None,
                       delta=None, *, mono: bool, nsteps: int,
                       hybrid: bool = False, hybrid_bitrate: bool = False,
                       hybrid_balance: bool = False):
    """Returns (residuals (T, L, C) int32, broke (L,) bool, ndec (L,)).
    slow/acc/delta are the hybrid profile's state."""
    fn = entropy_decode_cuda if _on_cuda(words) else entropy_decode
    return fn(words, nwords_lane, med, slow, acc, delta, mono=mono,
              nsteps=nsteps, hybrid=hybrid, hybrid_bitrate=hybrid_bitrate,
              hybrid_balance=hybrid_balance)


def entropy_decode_wvc_any(words, nwords_lane, med, slow, acc, delta, *,
                           mono: bool, hybrid_bitrate: bool,
                           hybrid_balance: bool, nsteps: int):
    """The hybrid profile with each word's narrowed interval: returns
    (residuals, maxcode, base, broke, ndec)."""
    kw = dict(mono=mono, nsteps=nsteps, hybrid_bitrate=hybrid_bitrate,
              hybrid_balance=hybrid_balance)
    if _on_cuda(words):
        return entropy_decode_wvc_cuda(words, nwords_lane, med, slow, acc,
                                       delta, **kw)
    return entropy_decode(words, nwords_lane, med, slow, acc, delta,
                          hybrid=True, wvc=True, **kw)


def wvc_corrections_any(wvc_words, maxcode, base, residuals):
    """Returns the corrections (T, L, C) int32 of a correction stream."""
    fn = wvc_corrections_cuda if _on_cuda(wvc_words) else wvc_corrections
    return fn(wvc_words, maxcode, base, residuals)
