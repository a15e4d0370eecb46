"""Wrapper of the CUDA decorrelation kernel (csrc/decorr.cu).

The kernel replaces wvpk/ops/decorr_pallas.py::_decorr_kernel with
fold_post; its plain version is ops/decorr.py::decorr_post, with the same
arguments and results. `decorr_post_wvc_cuda` is its wvc arm, whose plain
version is ops/decorr.py::decorr_post_wvc.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, consts

I32 = torch.int32
_INT32_MAX = (1 << 31) - 1


def _lib() -> ctypes.CDLL:
    lib = _build.load("decorr")
    fn = lib.wvpk_decorr_post
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    return lib


def _as_i32(name, t, shape, device, kernel="decorr"):
    """`t` as a contiguous int32 tensor on `device`; int64 inputs must
    hold int32 values (the staged histories do)."""
    if t.device != device or tuple(t.shape) != shape or t.dtype not in (
            torch.int32, torch.int64, torch.bool):
        raise ValueError(
            f"{kernel} kernel: {name} must be an integer tensor of shape "
            f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")
    return t.to(I32).contiguous()


def _launch(residuals, corr, terms, deltas, w0_a, w0_b, hist0_a, hist0_b,
            num_terms, nsamples, joint, mute_limit, *, mono: bool):
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
    wvc = corr is not None
    if wvc and (corr.device != dev or corr.dtype != I32
                or corr.shape != residuals.shape
                or not corr.is_contiguous()):
        raise ValueError(
            f"decorr kernel: corr must be contiguous int32 "
            f"{tuple(residuals.shape)} on {dev}, got {corr.dtype} "
            f"{tuple(corr.shape)} on {corr.device}")
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
    crc_wvc = torch.empty(L, dtype=I32, device=dev) if wvc else None
    first_bad = torch.empty(L, dtype=I32, device=dev)
    err = _lib().wvpk_decorr_post(
        residuals.data_ptr(), corr.data_ptr() if wvc else None,
        *(a.data_ptr() for a in args), out.data_ptr(), crc.data_ptr(),
        crc_wvc.data_ptr() if wvc else None, first_bad.data_ptr(), L, T,
        int(mono), int(wvc), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decorr kernel launch failed: CUDA error {err}")
    return out, crc, crc_wvc, first_bad


def decorr_post_cuda(residuals, terms, deltas, w0_a, w0_b, hist0_a, hist0_b,
                     num_terms, nsamples, joint, mute_limit, *, mono: bool):
    """Same contract as ops/decorr.py::decorr_post, on CUDA tensors."""
    out, crc, _, first_bad = _launch(
        residuals, None, terms, deltas, w0_a, w0_b, hist0_a, hist0_b,
        num_terms, nsamples, joint, mute_limit, mono=mono)
    decorr_post_cuda.launches += 1
    return out, crc, first_bad


def decorr_post_wvc_cuda(residuals, corr, terms, deltas, w0_a, w0_b,
                         hist0_a, hist0_b, num_terms, nsamples, joint,
                         mute_limit, *, mono: bool):
    """Same contract as ops/decorr.py::decorr_post_wvc, on CUDA
    tensors."""
    out = _launch(residuals, corr, terms, deltas, w0_a, w0_b, hist0_a,
                  hist0_b, num_terms, nsamples, joint, mute_limit, mono=mono)
    decorr_post_wvc_cuda.launches += 1
    return out


decorr_post_cuda.launches = 0
decorr_post_wvc_cuda.launches = 0
