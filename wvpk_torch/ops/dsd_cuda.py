"""Wrappers of the CUDA DSD kernels (csrc/dsd_fast.cu, csrc/dsd_high.cu).

`dsd_fast_decode_cuda` replaces wvpk/ops/dsd_pallas.py::_dsd_fast_kernel
(mode 1) and `dsd_high_decode_cuda` its _dsd_high_kernel (mode 3); their
plain versions are ops/dsd.py::dsd_fast_decode_bytes and
dsd_high_decode_bytes, with the same arguments and results. The kernels
write the byte-values straight into each lane's uint8 row, so the row
width (nsteps x channels) must be a multiple of 4, and read each lane's
payload row as aligned 32-bit words, so its width NB must be one too
(engine/dsd_pipeline.py::group_dsd pads it so).

Each wrapper checks, in one device-to-host read before its launch, what
the kernel cannot refuse by itself: no lane's `nbytes` exceeds NB, and
(mode 1) every `summed` entry lies in [0, 65535], since the kernel holds
the tables as uint16. It raises ValueError otherwise.
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


def _payload_width(NB, kernel):
    if NB % 4:
        raise ValueError(f"{kernel}: the payload row width {NB} must be a "
                         "multiple of 4")


def _check(kernel, NB, nbytes, summed=None):
    """One read of the limits the kernel relies on: max(nbytes) <= NB and,
    with `summed`, its entries in [0, 65535]."""
    parts = [nbytes.max()]
    if summed is not None:
        parts += list(torch.aminmax(summed))
    top, *span = torch.stack(parts).tolist()
    if top > NB:
        raise ValueError(f"{kernel}: nbytes {top} exceeds the payload row "
                         f"width {NB}")
    if span and (span[0] < 0 or span[1] > 0xFFFF):
        raise ValueError(f"{kernel}: summed entries must lie in [0, 65535], "
                         f"got [{span[0]}, {span[1]}]")


def _value0(value0, L, dev, kernel):
    if value0.device != dev or tuple(value0.shape) != (L,) \
            or value0.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{kernel}: value0 must be an integer (L,) tensor "
                         f"on {dev}")
    return (value0.to(torch.int64) & 0xFFFFFFFF).contiguous()


def dsd_fast_launcher(data, nbytes, summed, value0, nvals, *, bins: int,
                      mono: bool, nsteps: int):
    """dsd_fast_decode_cuda's inputs checked once: a callable that launches
    the kernel on them (on the current stream) and returns (out (L,
    nsteps) uint8, err (L,) int32, crc (L,) int32). The wrapper launches
    through it; timing it alone times the kernel without the checks."""
    L, NB = _payload(data, "dsd_fast_decode_cuda")
    W = _row_width(nsteps, 1, "dsd_fast_decode_cuda")
    _payload_width(NB, "dsd_fast_decode_cuda")
    dev = data.device
    args = [_as_i32("nbytes", nbytes, (L,), dev, "dsd_fast"),
            _as_i32("summed", summed, (L, bins * 256), dev, "dsd_fast"),
            _value0(value0, L, dev, "dsd_fast"),
            _as_i32("nvals", nvals, (L,), dev, "dsd_fast")]
    _check("dsd_fast_decode_cuda", NB, args[0], args[1])
    fn = _lib("dsd_fast", "wvpk_dsd_fast_decode", 8, 5).wvpk_dsd_fast_decode

    def launch():
        out = torch.empty((L, W), dtype=torch.uint8, device=dev)
        err = torch.empty(L, dtype=I32, device=dev)
        crc = torch.empty(L, dtype=I32, device=dev)
        rc = fn(data.data_ptr(), *(a.data_ptr() for a in args),
                out.data_ptr(), err.data_ptr(), crc.data_ptr(), L, NB, bins,
                nsteps, int(mono), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"dsd_fast kernel launch failed: CUDA error {rc}")
        return out, err, crc
    return launch


def dsd_fast_decode_cuda(data, nbytes, summed, value0, nvals, *, bins: int,
                         mono: bool, nsteps: int):
    """Same contract as ops/dsd.py::dsd_fast_decode_bytes, on CUDA
    tensors."""
    out, err, crc = dsd_fast_launcher(data, nbytes, summed, value0, nvals,
                                      bins=bins, mono=mono, nsteps=nsteps)()
    dsd_fast_decode_cuda.launches += 1
    return out, err != 0, crc


def dsd_high_launcher(data, nbytes, ptable0, filters0, value0, nsamples, *,
                      mono: bool, nsteps: int):
    """dsd_high_decode_cuda's inputs checked once: a callable that launches
    the kernel on them and returns (out (L, nsteps * C) uint8, crc (L,)
    int32, wide (1,) int32: the lanes it ran in the int64 body)."""
    L, NB = _payload(data, "dsd_high_decode_cuda")
    W = _row_width(nsteps, 1 if mono else 2, "dsd_high_decode_cuda")
    _payload_width(NB, "dsd_high_decode_cuda")
    dev = data.device
    args = [_as_i32("nbytes", nbytes, (L,), dev, "dsd_high"),
            _as_i32("ptable0", ptable0, (L, 256), dev, "dsd_high"),
            _as_i32("filters0", filters0, (L, 2, 8), dev, "dsd_high"),
            _value0(value0, L, dev, "dsd_high"),
            _as_i32("nsamples", nsamples, (L,), dev, "dsd_high")]
    _check("dsd_high_decode_cuda", NB, args[0])
    fn = _lib("dsd_high", "wvpk_dsd_high_decode", 9, 4).wvpk_dsd_high_decode

    def launch():
        out = torch.empty((L, W), dtype=torch.uint8, device=dev)
        crc = torch.empty(L, dtype=I32, device=dev)
        wide = torch.zeros(1, dtype=I32, device=dev)
        rc = fn(data.data_ptr(), *(a.data_ptr() for a in args),
                out.data_ptr(), crc.data_ptr(), wide.data_ptr(), L, NB,
                nsteps, int(mono), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"dsd_high kernel launch failed: CUDA error {rc}")
        return out, crc, wide
    return launch


def dsd_high_decode_cuda(data, nbytes, ptable0, filters0, value0, nsamples,
                         *, mono: bool, nsteps: int):
    """Same contract as ops/dsd.py::dsd_high_decode_bytes, on CUDA
    tensors."""
    out, crc, wide = dsd_high_launcher(data, nbytes, ptable0, filters0,
                                       value0, nsamples, mono=mono,
                                       nsteps=nsteps)()
    dsd_high_decode_cuda.launches += 1
    dsd_high_decode_cuda.wide_lanes = wide
    return out, crc


def int64_lanes(ptable0, filters0, mono: bool) -> torch.Tensor:
    """Which lanes csrc/dsd_high.cu runs in its int64 body: a (L,) bool
    tensor, True where a channel's f1..f5 leave [0, 2^20] or its |f6|
    exceeds 2^16, or a ptable entry leaves [-2^30, 2^30]."""
    f = filters0[:, :1 if mono else 2].to(torch.int64)
    p = ptable0.to(torch.int64)
    return (((f[..., :5] < 0) | (f[..., :5] > 1 << 20)).any(-1)
            | (f[..., 5].abs() > 1 << 16)).any(-1) \
        | ((p < -(1 << 30)) | (p > 1 << 30)).any(-1)


dsd_fast_decode_cuda.launches = 0
dsd_high_decode_cuda.launches = 0
# the last launch's count of lanes run in the int64 body (filters or
# ptable outside the 32-bit body's range), a (1,) int32 tensor on its
# device (0 on parsed streams)
dsd_high_decode_cuda.wide_lanes = None
