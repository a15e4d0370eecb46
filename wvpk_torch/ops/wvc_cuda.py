"""Wrapper of the CUDA correction-stream kernel (csrc/wvc.cu).

The kernel replaces wvpk/ops/entropy.py::wvc_corrections (an XLA scan,
not a Pallas kernel); its plain version is ops/entropy.py::
wvc_corrections, with the same arguments and results. Its bit cursor is a
32-bit position: a row of W words read by T C codes of at most 31 bits
each stays below 2^31 when (W + T C) 32 does, which the wrapper checks.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .entropy_cuda import _aligned, _check


def _lib() -> ctypes.CDLL:
    lib = _build.load("wvc")
    fn = lib.wvpk_wvc_corrections
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    return lib


def wvc_corrections_cuda(wvc_words, maxcode, base, residuals):
    """Same contract as ops/entropy.py::wvc_corrections, on CUDA
    tensors."""
    if not wvc_words.is_cuda:
        raise ValueError("wvc_corrections_cuda takes CUDA tensors")
    L, W = wvc_words.shape
    if L == 0 or W < 2:
        raise ValueError(f"wvc kernel: bad words shape {(L, W)}")
    T, _, C = maxcode.shape
    dev = wvc_words.device
    _check("wvc_words", wvc_words, torch.int32, (L, W), dev, "wvc")
    for name, t in (("maxcode", maxcode), ("base", base),
                    ("residuals", residuals)):
        _check(name, t, torch.int32, (T, L, C), dev, "wvc")
    if C not in (1, 2):
        raise ValueError(f"wvc kernel: {C} channels")
    if (W + T * C) * 32 >= 1 << 31:
        raise ValueError(f"wvc kernel: rows of {W} words read by {T * C} "
                         f"codes pass its 32-bit bit cursor (rows of 2^26 "
                         f"words or more never fit)")
    maxcode, base, residuals = (_aligned(t, C)
                                for t in (maxcode, base, residuals))
    corr = torch.empty((T, L, C), dtype=torch.int32, device=dev)
    err = _lib().wvpk_wvc_corrections(
        wvc_words.data_ptr(), maxcode.data_ptr(), base.data_ptr(),
        residuals.data_ptr(), corr.data_ptr(), L, W, T, int(C == 1),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wvc kernel launch failed: CUDA error {err}")
    wvc_corrections_cuda.launches += 1
    return corr


wvc_corrections_cuda.launches = 0
