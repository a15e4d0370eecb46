"""Native host runtime (C, loaded via ctypes).

Lazily compiles csrc/wvpk_host.c into a cached shared object on first use;
every entry point has a pure-Python fallback so the framework works
compiler-less. The device compute path is wvpk_torch's CUDA kernels
(csrc/*.cu) — this tier covers the host side (container scan, bitstream
staging memcpy fan-in) and the C encoders that testgen calls.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "csrc", "wvpk_host.c")
_lib = None
_tried = False

FIELDS_PER_HEADER = 8


def _build() -> ctypes.CDLL | None:
    src = open(_SRC, "rb").read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    cache = os.environ.get("WVPK_NATIVE_CACHE",
                           os.path.expanduser("~/.cache/wvpk-native"))
    os.makedirs(cache, exist_ok=True)
    so_path = os.path.join(cache, f"wvpk_host_{tag}.so")
    if not os.path.exists(so_path):
        cc = os.environ.get("CC", "cc")
        tmp = so_path + f".tmp{os.getpid()}"
        try:
            subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True, capture_output=True)
            os.replace(tmp, so_path)
        except (OSError, subprocess.CalledProcessError):
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
    lib.wvpk_scan_headers.restype = ctypes.c_long
    lib.wvpk_scan_headers.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_long]
    lib.wvpk_pack_streams.restype = None
    lib.wvpk_pack_streams.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
        ctypes.c_void_p, ctypes.c_long]
    lib.wvpk_parse_block.restype = ctypes.c_long
    lib.wvpk_parse_block.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64)]
    return lib


def get_lib() -> ctypes.CDLL | None:
    global _lib, _tried
    if not _tried:
        _tried = True
        if os.environ.get("WVPK_NO_NATIVE"):
            _lib = None
        else:
            _lib = _build()
    return _lib


def scan_headers_native(data: bytes) -> np.ndarray | None:
    """(N, 8) int64 header fields, or None when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    max_headers = max(len(data) // 40 + 4, 16)
    out = np.empty((max_headers, FIELDS_PER_HEADER), np.int64)
    n = lib.wvpk_scan_headers(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_headers)
    return out[:n]


# state-array field layout of wvpk_parse_block (keep in sync with the C
# enum in csrc/wvpk_host.c)
PARSE_NFIELDS = 353


def parse_block_native(data: bytes, hpos: int) -> np.ndarray | None:
    """Parse one PCM block's metadata into the flat int64 state array.
    None = unavailable / needs the Python path (DSD, context updates,
    or malformed metadata — the Python path reproduces exact errors)."""
    lib = get_lib()
    if lib is None:
        return None
    st = np.zeros(PARSE_NFIELDS, np.int64)
    rc = lib.wvpk_parse_block(
        data, len(data), hpos,
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return st if rc == 0 else None


def pack_streams_native(payloads: list[bytes], stride: int) -> np.ndarray | None:
    """(L, stride) uint8 matrix, 0xff-filled, rows = payloads; or None."""
    lib = get_lib()
    if lib is None:
        return None
    blob = b"".join(payloads)
    offs = np.zeros(len(payloads), np.int64)
    lens = np.asarray([len(p) for p in payloads], np.int64)
    np.cumsum(lens[:-1], out=offs[1:]) if len(payloads) > 1 else None
    out = np.full((len(payloads), stride), 0xFF, np.uint8)
    lib.wvpk_pack_streams(
        blob, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(payloads), out.ctypes.data_as(ctypes.c_void_p), stride)
    return out


# ---------------------------------------------------------------------------
# native lossless encode (csrc/wvpk_encode.c)
# ---------------------------------------------------------------------------

_ENC_SRC = os.path.join(os.path.dirname(__file__), "csrc", "wvpk_encode.c")
_enc_lib = None
_enc_tried = False

PSTATE_INTS = 21  # term,delta,wa,wb,m,sa[8],sb[8] per pass


def _build_encode() -> ctypes.CDLL | None:
    src = open(_ENC_SRC, "rb").read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    cache = os.environ.get("WVPK_NATIVE_CACHE",
                           os.path.expanduser("~/.cache/wvpk-native"))
    os.makedirs(cache, exist_ok=True)
    so_path = os.path.join(cache, f"wvpk_encode_{tag}.so")
    if not os.path.exists(so_path):
        cc = os.environ.get("CC", "cc")
        tmp = so_path + f".tmp{os.getpid()}"
        try:
            subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", "-o", tmp, _ENC_SRC],
                check=True, capture_output=True)
            os.replace(tmp, so_path)
        except (OSError, subprocess.CalledProcessError):
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
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


def get_encode_lib() -> ctypes.CDLL | None:
    global _enc_lib, _enc_tried
    if not _enc_tried:
        _enc_tried = True
        if os.environ.get("WVPK_NO_NATIVE"):
            _enc_lib = None
        else:
            _enc_lib = _build_encode()
    return _enc_lib


def encode_block_native(targ: np.ndarray, mono: bool, flags: int,
                        pstate: np.ndarray, medians: np.ndarray,
                        wstate: np.ndarray, wvc: bool = False):
    """Run the C block encoder (lossless AND hybrid). targ (n, ch) int32
    joint-domain targets; pstate (npasses, 21) int32, medians (6,) int32
    and wstate (6,) int64 [slow0, slow1, bacc0, bacc1, bdelta0, bdelta1]
    are mutated in place on success. Returns (payload_bytes, decoded
    (n, ch) int32) — or with wvc=True (hybrid-lossless) a 3-tuple with
    the correction-stream payload appended — or None (unavailable /
    degenerate regime -> Python fallback)."""
    from ..tables import EXP2_NP, LOG2_NP
    lib = get_encode_lib()
    if lib is None:
        return None
    n, ch = targ.shape
    targ = np.ascontiguousarray(targ, np.int32)
    decoded = np.zeros((n, ch), np.int32)
    cap = n * ch * 24 + 4096
    buf = ctypes.create_string_buffer(cap)  # zero-initialized
    bitlen = ctypes.c_int64(0)
    wvc_buf = ctypes.create_string_buffer(cap) if wvc else None
    wvc_bitlen = ctypes.c_int64(0)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.wvpk_encode_block(
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


def _pack_lanes_all(lib, sa_lo, sa_hi, sa_len, sb_bits, sb_len, tails):
    """One-call batched packer: wvpk_pack_lanes_all walks the row-major
    (W, L) segment arrays in lane tiles, so no transposed copies of the
    ~35 MB of segment data and one ctypes crossing instead of L (the
    per-lane path spent most of its time in numpy strided copies)."""
    if not hasattr(lib, "_packall_sig"):
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.wvpk_pack_lanes_all.restype = ctypes.c_long
        lib.wvpk_pack_lanes_all.argtypes = [
            u64p, u64p, i32p, u64p, i32p, ctypes.c_long, ctypes.c_long,
            ctypes.c_char_p, i64p, i32p,
            ctypes.c_char_p, i64p, i64p, i64p]
        lib._packall_sig = True
    W, L = sa_len.shape
    if L == 0:
        return []
    a_lo = np.ascontiguousarray(sa_lo, np.uint64)
    a_hi = np.ascontiguousarray(sa_hi, np.uint64)
    a_ln = np.ascontiguousarray(sa_len, np.int32)
    b_bits = np.ascontiguousarray(sb_bits, np.uint64)
    b_ln = np.ascontiguousarray(sb_len, np.int32)
    total = (a_ln.sum(axis=0, dtype=np.int64)
             + b_ln.sum(axis=0, dtype=np.int64))
    tail_lens = np.asarray([len(tb) for tb, _ in tails], np.int64)
    tail_bits = np.asarray([tn for _, tn in tails], np.int32)
    tail_offs = np.zeros(L, np.int64)
    np.cumsum(tail_lens[:-1], out=tail_offs[1:])
    tails_blob = b"".join(bytes(tb) for tb, _ in tails)
    caps = (((total + tail_bits) // 8 + 24) & ~7).astype(np.int64)
    out_offs = np.zeros(L, np.int64)
    np.cumsum(caps[:-1], out=out_offs[1:])
    out = np.zeros(int(caps.sum()), np.uint8)
    bitlens = np.zeros(L, np.int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.wvpk_pack_lanes_all(
        a_lo.ctypes.data_as(u64p), a_hi.ctypes.data_as(u64p),
        a_ln.ctypes.data_as(i32p), b_bits.ctypes.data_as(u64p),
        b_ln.ctypes.data_as(i32p), W, L,
        tails_blob, tail_offs.ctypes.data_as(i64p),
        tail_bits.ctypes.data_as(i32p),
        out.ctypes.data_as(ctypes.c_char_p),
        out_offs.ctypes.data_as(i64p), caps.ctypes.data_as(i64p),
        bitlens.ctypes.data_as(i64p))
    if rc != 0:
        return None
    return [out[int(out_offs[i]):int(out_offs[i])
                + (int(bitlens[i]) + 7) // 8].tobytes()
            for i in range(L)]


def dsd_encode_fast_native(codes: np.ndarray, probs: np.ndarray,
                           summed: np.ndarray, bins: int,
                           mono: bool) -> bytes | None:
    """C range-encode of interleaved DSD byte-samples over per-bin
    probability tables (mode 1 "fast"; the inverse of
    DsdUtils.cs:244-304). None -> Python fallback."""
    lib = get_encode_lib()
    if lib is None or not hasattr(lib, "wvpk_dsd_encode_fast"):
        return None
    if not hasattr(lib, "_dsd_fast_sig"):
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.wvpk_dsd_encode_fast.restype = ctypes.c_long
        lib.wvpk_dsd_encode_fast.argtypes = [
            i32p, ctypes.c_long, i32p, i32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int64)]
        lib._dsd_fast_sig = True
    codes = np.ascontiguousarray(codes, np.int32)
    probs = np.ascontiguousarray(probs, np.int32)
    summed = np.ascontiguousarray(summed, np.int32)
    cap = codes.size * 4 + 64
    buf = ctypes.create_string_buffer(cap)
    outlen = ctypes.c_int64(0)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.wvpk_dsd_encode_fast(
        codes.ctypes.data_as(i32p), codes.size,
        probs.ctypes.data_as(i32p), summed.ctypes.data_as(i32p),
        int(bins), int(mono), buf, cap, ctypes.byref(outlen))
    if rc != 0:
        return None
    return buf.raw[:int(outlen.value)]


def dsd_encode_high_native(data: np.ndarray, filters_init: np.ndarray,
                           ptable: np.ndarray, nch: int) -> bytes | None:
    """C arithmetic-encode of (nframes, nch) DSD byte-samples with the
    adaptive ptable + filter-bank predictor (mode 3 "high"; the inverse
    of DsdUtils.cs:391-493). None -> Python fallback."""
    lib = get_encode_lib()
    if lib is None or not hasattr(lib, "wvpk_dsd_encode_high"):
        return None
    if not hasattr(lib, "_dsd_high_sig"):
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.wvpk_dsd_encode_high.restype = ctypes.c_long
        lib.wvpk_dsd_encode_high.argtypes = [
            i32p, ctypes.c_long, ctypes.c_int, i32p, i32p,
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int64)]
        lib._dsd_high_sig = True
    data = np.ascontiguousarray(data, np.int32)
    filters_init = np.ascontiguousarray(filters_init, np.int32)
    ptable = np.ascontiguousarray(ptable, np.int32)
    nframes = data.size // nch
    # worst case ~1 emitted byte per coded bit before the adaptive
    # table converges, + flush
    cap = data.size * 9 + 64
    buf = ctypes.create_string_buffer(cap)
    outlen = ctypes.c_int64(0)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.wvpk_dsd_encode_high(
        data.ctypes.data_as(i32p), nframes, int(nch),
        filters_init.ctypes.data_as(i32p), ptable.ctypes.data_as(i32p),
        buf, cap, ctypes.byref(outlen))
    if rc != 0:
        return None
    return buf.raw[:int(outlen.value)]


def pack_lanes_native(sa_lo, sa_hi, sa_len, sb_bits, sb_len, tails):
    """C packing of the device-encoder's (W, L) segment arrays into
    per-lane payload bytes; None -> numpy fallback."""
    lib = get_encode_lib()
    if lib is None or not hasattr(lib, "wvpk_pack_lane"):
        return None
    if hasattr(lib, "wvpk_pack_lanes_all"):
        res = _pack_lanes_all(lib, sa_lo, sa_hi, sa_len, sb_bits, sb_len,
                              tails)
        if res is not None:
            return res
    if not hasattr(lib, "_pack_sig"):
        lib.wvpk_pack_lane.restype = ctypes.c_long
        lib.wvpk_pack_lane.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
            ctypes.c_long, ctypes.POINTER(ctypes.c_int64)]
        lib._pack_sig = True
    W, L = sa_len.shape
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    a_lo = np.ascontiguousarray(sa_lo.T, np.uint64)    # (L, W) rows
    a_hi = np.ascontiguousarray(sa_hi.T, np.uint64)
    a_ln = np.ascontiguousarray(sa_len.T, np.int32)
    b_bits = np.ascontiguousarray(sb_bits.T, np.uint64)
    b_ln = np.ascontiguousarray(sb_len.T, np.int32)
    total = (a_ln.sum(axis=1, dtype=np.int64)
             + b_ln.sum(axis=1, dtype=np.int64))
    out = []
    for lane in range(L):
        tb, tn = tails[lane]
        cap = (int(total[lane] + tn) // 8 + 24) & ~7
        buf = ctypes.create_string_buffer(cap)
        bl = ctypes.c_int64(0)
        rc = lib.wvpk_pack_lane(
            a_lo[lane].ctypes.data_as(u64p), a_hi[lane].ctypes.data_as(u64p),
            a_ln[lane].ctypes.data_as(i32p),
            b_bits[lane].ctypes.data_as(u64p),
            b_ln[lane].ctypes.data_as(i32p), W,
            bytes(tb), tn, buf, cap, ctypes.byref(bl))
        if rc != 0:
            return None
        out.append(buf.raw[:(int(bl.value) + 7) // 8])
    return out
