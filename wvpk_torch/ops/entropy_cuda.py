"""Wrapper of the CUDA entropy kernel (csrc/entropy.cu).

The kernel replaces wvpk/ops/entropy_pallas.py::_entropy_kernel for the
lossless profile; its plain version is ops/entropy.py::entropy_decode,
with the same arguments and results.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build


def _lib() -> ctypes.CDLL:
    lib = _build.load("entropy")
    fn = lib.wvpk_entropy_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"entropy kernel: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def entropy_decode_cuda(words, nwords_lane, med0, *, mono: bool,
                        nsteps: int):
    """Same contract as ops/entropy.py::entropy_decode, on CUDA tensors."""
    if not words.is_cuda:
        raise ValueError("entropy_decode_cuda takes CUDA tensors")
    L, W = words.shape
    if L == 0 or W < 2:
        raise ValueError(f"entropy kernel: bad words shape {(L, W)}")
    dev = words.device
    _check("words", words, torch.int32, (L, W), dev)
    _check("nwords_lane", nwords_lane, torch.int32, (L,), dev)
    _check("med0", med0, torch.int64, (L, 2, 3), dev)
    C = 1 if mono else 2
    T = nsteps // C
    res = torch.empty((T, L, C), dtype=torch.int32, device=dev)
    broke = torch.empty(L, dtype=torch.int32, device=dev)
    ndec = torch.empty(L, dtype=torch.int32, device=dev)
    err = _lib().wvpk_entropy_decode(
        words.data_ptr(), med0.data_ptr(), nwords_lane.data_ptr(),
        res.data_ptr(), broke.data_ptr(), ndec.data_ptr(), L, W, T,
        int(mono), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"entropy kernel launch failed: CUDA error {err}")
    entropy_decode_cuda.launches += 1
    return res, broke != 0, ndec


entropy_decode_cuda.launches = 0
