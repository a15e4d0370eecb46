"""Wrapper of the CUDA entropy kernel (csrc/entropy.cu).

The kernel replaces wvpk/ops/entropy_pallas.py::_entropy_kernel, lossless
and hybrid profiles; its plain version is ops/entropy.py::entropy_decode,
with the same arguments and results. The kernel keeps bit positions in
32 bits, so a lane's row holds fewer than 2^26 words. `entropy_decode_wvc_cuda` is the
hybrid profile with the wvc outputs (entropy_decode(..., wvc=True)).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..tables import EXP2_NP, LOG2_NP


def _lib() -> ctypes.CDLL:
    lib = _build.load("entropy")
    fn = lib.wvpk_entropy_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> torch.Tensor:
    """The log2 then exp2 tables, 256 int32 each, on `device`."""
    return torch.from_numpy(np.concatenate([LOG2_NP, EXP2_NP])).to(device)


def _check(name, t, dtype, shape, device, kernel="entropy"):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{kernel} kernel: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _aligned(t, C):
    """`t`, copied if needed so its data is aligned to 4 C bytes: the
    staging kernels (csrc/stage.cuh) copy a lane's C values of a step with
    one cp.async of that size (a fresh tensor is aligned)."""
    return t if t.data_ptr() % (4 * C) == 0 else t.clone()


def _launch(words, nwords_lane, med0, slow0, acc0, delta0, *, mono, nsteps,
            hybrid, hybrid_bitrate, hybrid_balance, wvc):
    if not words.is_cuda:
        raise ValueError("entropy_decode_cuda takes CUDA tensors")
    L, W = words.shape
    if L == 0 or W < 2:
        raise ValueError(f"entropy kernel: bad words shape {(L, W)}")
    if W * 32 >= 1 << 31:
        raise ValueError(f"entropy kernel: {W} words a lane: bit positions "
                         "must fit int32")
    dev = words.device
    _check("words", words, torch.int32, (L, W), dev)
    _check("nwords_lane", nwords_lane, torch.int32, (L,), dev)
    _check("med0", med0, torch.int64, (L, 2, 3), dev)
    if hybrid:
        for name, t in (("slow0", slow0), ("acc0", acc0),
                        ("delta0", delta0)):
            if t is None:
                raise ValueError(f"the hybrid profile needs {name}")
            _check(name, t, torch.int64, (L, 2), dev)
    C = 1 if mono else 2
    T = nsteps // C
    res = torch.empty((T, L, C), dtype=torch.int32, device=dev)
    mc = torch.empty_like(res) if wvc else None
    base = torch.empty_like(res) if wvc else None
    broke = torch.empty(L, dtype=torch.int32, device=dev)
    ndec = torch.empty(L, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _lib().wvpk_entropy_decode(
        words.data_ptr(), med0.data_ptr(),
        ptr(slow0 if hybrid else None), ptr(acc0 if hybrid else None),
        ptr(delta0 if hybrid else None),
        ptr(_tables(dev) if hybrid else None), nwords_lane.data_ptr(),
        res.data_ptr(), ptr(mc), ptr(base), broke.data_ptr(),
        ndec.data_ptr(), L, W, T, int(mono), int(hybrid),
        int(hybrid and hybrid_bitrate), int(hybrid and hybrid_balance),
        int(wvc), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"entropy kernel launch failed: CUDA error {err}")
    return res, mc, base, broke != 0, ndec


def entropy_decode_cuda(words, nwords_lane, med0, slow0=None, acc0=None,
                        delta0=None, *, mono: bool, nsteps: int,
                        hybrid: bool = False, hybrid_bitrate: bool = False,
                        hybrid_balance: bool = False):
    """Same contract as ops/entropy.py::entropy_decode (wvc=False), on
    CUDA tensors."""
    res, _mc, _base, broke, ndec = _launch(
        words, nwords_lane, med0, slow0, acc0, delta0, mono=mono,
        nsteps=nsteps, hybrid=hybrid, hybrid_bitrate=hybrid_bitrate,
        hybrid_balance=hybrid_balance, wvc=False)
    entropy_decode_cuda.launches += 1
    return res, broke, ndec


def entropy_decode_wvc_cuda(words, nwords_lane, med0, slow0, acc0, delta0,
                            *, mono: bool, nsteps: int,
                            hybrid_bitrate: bool, hybrid_balance: bool):
    """Same contract as ops/entropy.py::entropy_decode(..., hybrid=True,
    wvc=True), on CUDA tensors: (residuals, maxcode, base, broke, ndec)."""
    out = _launch(words, nwords_lane, med0, slow0, acc0, delta0, mono=mono,
                  nsteps=nsteps, hybrid=True, hybrid_bitrate=hybrid_bitrate,
                  hybrid_balance=hybrid_balance, wvc=True)
    entropy_decode_wvc_cuda.launches += 1
    return out


entropy_decode_cuda.launches = 0
entropy_decode_wvc_cuda.launches = 0
