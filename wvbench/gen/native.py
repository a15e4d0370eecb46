"""Loader of the generator's C block encoder (csrc/wvpk_encode.c).

Frozen copy of the encode half of wvpk_torch/native/__init__.py. The
library is built with `cc` into `build/wvbench/` at the root of the
checkout, a fixed directory, so only the first run in a checkout builds
it. Unlike the program's loader there is no silent fallback: `lib()`
raises when the library cannot be built or loaded, since the pure-Python
encoder would take hours on the benchmark's pools.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "csrc", "wvpk_encode.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "wvbench")
PSTATE_INTS = 21  # term,delta,wa,wb,m,sa[8],sb[8] per pass

_lib = None


def _build() -> ctypes.CDLL:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"wvpk_encode_{tag}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        subprocess.run([os.environ.get("CC", "cc"), "-O2", "-shared",
                        "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    lib.wvpk_encode_block.restype = ctypes.c_long
    lib.wvpk_encode_block.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64),
        # hybrid-lossless correction stream (NULL = plain hybrid)
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int64)]
    return lib


def lib() -> ctypes.CDLL:
    """The loaded C encoder, built at first use."""
    global _lib
    if _lib is None:
        _lib = _build()
    return _lib


def encode_block_native(targ: np.ndarray, mono: bool, flags: int,
                        pstate: np.ndarray, medians: np.ndarray,
                        wstate: np.ndarray, wvc: bool = False):
    """Run the C block encoder (lossless AND hybrid). targ (n, ch) int32
    joint-domain targets; pstate (npasses, 21) int32, medians (6,) int32
    and wstate (6,) int64 [slow0, slow1, bacc0, bacc1, bdelta0, bdelta1]
    are mutated in place on success. Returns (payload_bytes, decoded
    (n, ch) int32) — or with wvc=True (hybrid-lossless) a 3-tuple with
    the correction-stream payload appended — or None (degenerate regime
    -> the Python encoder)."""
    from ..ref.tables import EXP2_NP, LOG2_NP
    n, ch = targ.shape
    targ = np.ascontiguousarray(targ, np.int32)
    decoded = np.zeros((n, ch), np.int32)
    cap = n * ch * 24 + 4096
    buf = ctypes.create_string_buffer(cap)  # zero-initialized
    bitlen = ctypes.c_int64(0)
    wvc_buf = ctypes.create_string_buffer(cap) if wvc else None
    wvc_bitlen = ctypes.c_int64(0)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib().wvpk_encode_block(
        targ.ctypes.data_as(i32p), n, int(mono), int(flags),
        pstate.shape[0], pstate.ctypes.data_as(i32p),
        medians.ctypes.data_as(i32p),
        wstate.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        LOG2_NP.ctypes.data_as(i32p), EXP2_NP.ctypes.data_as(i32p),
        decoded.ctypes.data_as(i32p), buf, cap, ctypes.byref(bitlen),
        wvc_buf, cap if wvc else 0, ctypes.byref(wvc_bitlen))
    if rc != 0:
        return None
    nbytes = (int(bitlen.value) + 7) // 8
    if wvc:
        wn = (int(wvc_bitlen.value) + 7) // 8
        return buf.raw[:nbytes], decoded, wvc_buf.raw[:wn]
    return buf.raw[:nbytes], decoded
