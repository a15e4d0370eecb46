"""Wrappers of the CUDA DSD kernels (csrc/dsd_fast.cu, csrc/dsd_high.cu).

`dsd_fast_decode_cuda` replaces wvpk/ops/dsd_pallas.py::_dsd_fast_kernel
(mode 1) and `dsd_high_decode_cuda` its _dsd_high_kernel (mode 3); their
plain versions are ops/dsd.py::dsd_fast_decode_bytes and
dsd_high_decode_bytes, with the same arguments and results. The kernels
write the byte-values straight into each lane's uint8 row, so the row
width (nsteps x channels) must be a multiple of 4.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .decorr_cuda import _as_i32

I32 = torch.int32


def _lib(name: str, fn_name: str, nptr: int, nint: int) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * nint \
        + [ctypes.c_void_p]
    return lib


def _payload(data, kernel):
    if not data.is_cuda:
        raise ValueError(f"{kernel} takes CUDA tensors")
    if data.dim() != 2 or data.dtype != torch.uint8 or data.shape[0] == 0 \
            or data.shape[1] == 0 or not data.is_contiguous():
        raise ValueError(f"{kernel}: data must be a contiguous uint8 (L, NB) "
                         f"tensor, got {data.dtype} {tuple(data.shape)}")
    return data.shape


def _row_width(nsteps, C, kernel):
    if nsteps * C % 4:
        raise ValueError(f"{kernel}: nsteps x channels ({nsteps} x {C}) "
                         "must be a multiple of 4")
    return nsteps * C


def _value0(value0, L, dev, kernel):
    if value0.device != dev or tuple(value0.shape) != (L,) \
            or value0.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{kernel}: value0 must be an integer (L,) tensor "
                         f"on {dev}")
    return (value0.to(torch.int64) & 0xFFFFFFFF).contiguous()


def dsd_fast_decode_cuda(data, nbytes, summed, value0, nvals, *, bins: int,
                         mono: bool, nsteps: int):
    """Same contract as ops/dsd.py::dsd_fast_decode_bytes, on CUDA
    tensors."""
    L, NB = _payload(data, "dsd_fast_decode_cuda")
    W = _row_width(nsteps, 1, "dsd_fast_decode_cuda")
    dev = data.device
    args = [_as_i32("nbytes", nbytes, (L,), dev, "dsd_fast"),
            _as_i32("summed", summed, (L, bins * 256), dev, "dsd_fast"),
            _value0(value0, L, dev, "dsd_fast"),
            _as_i32("nvals", nvals, (L,), dev, "dsd_fast")]
    out = torch.empty((L, W), dtype=torch.uint8, device=dev)
    err = torch.empty(L, dtype=I32, device=dev)
    crc = torch.empty(L, dtype=I32, device=dev)
    rc = _lib("dsd_fast", "wvpk_dsd_fast_decode", 8, 5).wvpk_dsd_fast_decode(
        data.data_ptr(), *(a.data_ptr() for a in args), out.data_ptr(),
        err.data_ptr(), crc.data_ptr(), L, NB, bins, nsteps, int(mono),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dsd_fast kernel launch failed: CUDA error {rc}")
    dsd_fast_decode_cuda.launches += 1
    return out, err != 0, crc


def dsd_high_decode_cuda(data, nbytes, ptable0, filters0, value0, nsamples,
                         *, mono: bool, nsteps: int):
    """Same contract as ops/dsd.py::dsd_high_decode_bytes, on CUDA
    tensors."""
    L, NB = _payload(data, "dsd_high_decode_cuda")
    W = _row_width(nsteps, 1 if mono else 2, "dsd_high_decode_cuda")
    dev = data.device
    args = [_as_i32("nbytes", nbytes, (L,), dev, "dsd_high"),
            _as_i32("ptable0", ptable0, (L, 256), dev, "dsd_high"),
            _as_i32("filters0", filters0, (L, 2, 8), dev, "dsd_high"),
            _value0(value0, L, dev, "dsd_high"),
            _as_i32("nsamples", nsamples, (L,), dev, "dsd_high")]
    out = torch.empty((L, W), dtype=torch.uint8, device=dev)
    crc = torch.empty(L, dtype=I32, device=dev)
    rc = _lib("dsd_high", "wvpk_dsd_high_decode", 8, 4).wvpk_dsd_high_decode(
        data.data_ptr(), *(a.data_ptr() for a in args), out.data_ptr(),
        crc.data_ptr(), L, NB, nsteps, int(mono),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dsd_high kernel launch failed: CUDA error {rc}")
    dsd_high_decode_cuda.launches += 1
    return out, crc


dsd_fast_decode_cuda.launches = 0
dsd_high_decode_cuda.launches = 0
