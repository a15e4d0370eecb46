"""Wrapper of the CUDA wvx injection kernel (csrc/wvx.cu).

The kernel replaces wvpk/ops/post.py::wvx_inject (an XLA scan, not a
Pallas kernel); its plain version is ops/post.py::wvx_inject, with the
same arguments and results. A lane's bit cursor is a 32-bit position
where it provably fits (`int64_lanes`, the proof in the source); other
lanes run the same body on 64-bit cursors in the same launch.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .decorr_cuda import _as_i32
from .entropy_cuda import _aligned

I32 = torch.int32


def _lib() -> ctypes.CDLL:
    lib = _build.load("wvx")
    fn = lib.wvpk_wvx_inject
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    return lib


def wvx_inject_cuda(out, nsamples, wvx_words, wvx_start_bit, wvx_start_bc,
                    sent_bits, max_width, int32_zod, false_stereo=None):
    """Same contract as ops/post.py::wvx_inject, on CUDA tensors."""
    if not out.is_cuda:
        raise ValueError("wvx_inject_cuda takes CUDA tensors")
    T, L, C = out.shape
    if L == 0 or C not in (1, 2) or out.dtype != I32 \
            or not out.is_contiguous():
        raise ValueError(f"wvx kernel: out must be contiguous int32 "
                         f"(T, L, 1|2), got {out.dtype} {tuple(out.shape)}")
    dev = out.device
    W = wvx_words.shape[1] if wvx_words.dim() == 2 else 0
    if W < 2:
        raise ValueError(f"wvx kernel: bad words shape "
                         f"{tuple(wvx_words.shape)}")
    words = _as_i32("wvx_words", wvx_words, (L, W), dev, "wvx")
    args = [_as_i32("nsamples", nsamples, (L,), dev, "wvx"), words,
            _as_i32("wvx_start_bit", wvx_start_bit, (L,), dev, "wvx"),
            _as_i32("wvx_start_bc", wvx_start_bc, (L,), dev, "wvx"),
            _as_i32("sent_bits", sent_bits, (L,), dev, "wvx"),
            _as_i32("max_width", max_width, (L,), dev, "wvx"),
            _as_i32("int32_zod", int32_zod, (L, 3), dev, "wvx")]
    fs = None if false_stereo is None else \
        _as_i32("false_stereo", false_stereo, (L,), dev, "wvx")
    out = _aligned(out, C)   # a stereo sample is one 8-byte access
    res = torch.empty((T, L, C), dtype=I32, device=dev)
    crc_x = torch.empty(L, dtype=I32, device=dev)
    wide = torch.zeros(1, dtype=I32, device=dev)
    err = _lib().wvpk_wvx_inject(
        out.data_ptr(), *(a.data_ptr() for a in args),
        None if fs is None else fs.data_ptr(), res.data_ptr(),
        crc_x.data_ptr(), wide.data_ptr(), L, W, T, int(C == 1),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wvx kernel launch failed: CUDA error {err}")
    wvx_inject_cuda.launches += 1
    wvx_inject_cuda.wide_lanes = wide
    return res, crc_x


def int64_lanes(T, C, nsamples, wvx_start_bit, sent_bits,
                false_stereo=None) -> torch.Tensor:
    """Which lanes csrc/wvx.cu runs on 64-bit cursors: a (L,) bool tensor,
    True unless 0 <= start_bit, sent_bits <= 255 and start_bit + n
    max(sent_bits, 0) < 2^31, n the lane's valid values (C per sample
    below min(nsamples, T), and as many again over the FALSE_STEREO
    pass's zeros)."""
    nt = nsamples.to(torch.int64).clamp(0, T)
    n = nt * C
    if false_stereo is not None:
        n = n + torch.where(false_stereo.bool(), nt, 0)
    sb = sent_bits.to(torch.int64)
    sbit = wvx_start_bit.to(torch.int64)
    return (sbit < 0) | (sb > 255) | (sbit + n * sb.clamp(min=0) >= 1 << 31)


wvx_inject_cuda.launches = 0
# the last launch's count of lanes run on 64-bit cursors (int64_lanes), a
# (1,) int32 tensor on its device (0 on staged lanes)
wvx_inject_cuda.wide_lanes = None

