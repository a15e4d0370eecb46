"""Wrapper of the CUDA decorrelation kernel (csrc/decorr.cu).

The kernel replaces wvpk/ops/decorr_pallas.py::_decorr_kernel with
fold_post; its plain version is ops/decorr.py::decorr_post, with the same
arguments and results.
"""

from __future__ import annotations

import ctypes

import torch

from wvpk import consts

from .. import _build

I32 = torch.int32
_INT32_MAX = (1 << 31) - 1


def _lib() -> ctypes.CDLL:
    lib = _build.load("decorr")
    fn = lib.wvpk_decorr_post
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    return lib


def _as_i32(name, t, shape, device):
    """`t` as a contiguous int32 tensor on `device`; int64 inputs must
    hold int32 values (the staged histories do)."""
    if t.device != device or tuple(t.shape) != shape or t.dtype not in (
            torch.int32, torch.int64, torch.bool):
        raise ValueError(
            f"decorr kernel: {name} must be an integer tensor of shape "
            f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")
    return t.to(I32).contiguous()


def decorr_post_cuda(residuals, terms, deltas, w0_a, w0_b, hist0_a, hist0_b,
                     num_terms, nsamples, joint, mute_limit, *, mono: bool):
    """Same contract as ops/decorr.py::decorr_post, on CUDA tensors."""
    if not residuals.is_cuda:
        raise ValueError("decorr_post_cuda takes CUDA tensors")
    T, L, C = residuals.shape
    if L == 0 or C != (1 if mono else 2) or residuals.dtype != I32 \
            or not residuals.is_contiguous():
        raise ValueError(
            f"decorr kernel: residuals must be contiguous int32 (T, L, "
            f"{1 if mono else 2}), got {residuals.dtype} "
            f"{tuple(residuals.shape)}")
    dev = residuals.device
    nt = consts.MAX_NTERMS
    args = [_as_i32("terms", terms, (L, nt), dev),
            _as_i32("deltas", deltas, (L, nt), dev),
            _as_i32("w0_a", w0_a, (L, nt), dev),
            _as_i32("w0_b", w0_b, (L, nt), dev),
            _as_i32("hist0_a", hist0_a, (L, nt, 8), dev),
            _as_i32("hist0_b", hist0_b, (L, nt, 8), dev),
            _as_i32("num_terms", num_terms, (L,), dev),
            _as_i32("nsamples", nsamples, (L,), dev),
            _as_i32("joint", joint, (L,), dev),
            # limits past int32 can never fire: |cabs| <= 2^31 - 1
            _as_i32("mute_limit", torch.clamp(mute_limit, max=_INT32_MAX),
                    (L,), dev)]
    out = torch.empty((T, L, C), dtype=I32, device=dev)
    crc = torch.empty(L, dtype=I32, device=dev)
    first_bad = torch.empty(L, dtype=I32, device=dev)
    err = _lib().wvpk_decorr_post(
        residuals.data_ptr(), *(a.data_ptr() for a in args),
        out.data_ptr(), crc.data_ptr(), first_bad.data_ptr(), L, T,
        int(mono), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decorr kernel launch failed: CUDA error {err}")
    decorr_post_cuda.launches += 1
    return out, crc, first_bad


decorr_post_cuda.launches = 0
