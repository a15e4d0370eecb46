"""Wrappers of the CUDA encode kernels (csrc/encode_invert.cu,
csrc/encode_words.cu, csrc/encode_hybrid.cu).

- `decorr_invert_cuda` replaces wvpk/ops/encode_pallas.py::_invert_kernel;
  its plain version is ops/encode_kernels.py::decorr_invert_warm, with the
  same arguments and results.
- `encode_words_cuda` replaces ::_encode_words_kernel and
  `hybrid_encode_cuda` ::_hybrid_kernel. Both write each lane's payload
  directly; their plain versions are `encode_words_plain` and
  `hybrid_encode_plain` (the scans of ops/encode_kernels.py packed by
  ops/encode_pack.py::pack_segments_device), with the same arguments and
  results: (words (L, payload_cap(W)) int32, zero past each lane's end;
  total_bits (L,) int64), and for hybrid the reconstruction (T, L, C).

csrc/encode_invert.cu and csrc/encode_hybrid.cu compile one kernel for
each chain of decorr_cuda.ENCODE_CHAINS (its weights and rings in
registers; the decode kernel's own chains, past them, are not) and a
run-time kernel for any chain; `static_terms` (wvpk's argument: every lane
carries this chain) picks the chain's kernel, as decorr_cuda.lane_runs
does (`chain_kernel`). Both coders run lanes whose medians fit int32 in
32-bit arithmetic and any other lane with int64 medians in the same kernel
(`int64_lanes`).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .decorr_cuda import ENCODE_CHAINS, ENCODE_INSTANCES, GENERIC, \
    _as_i32, instance_name, lane_runs
from .encode_kernels import entropy_encode_words, hybrid_encode_scan
from .encode_pack import pack_segments_device, payload_cap
from .entropy_cuda import _aligned, _check, _tables

I32 = torch.int32
I64 = torch.int64
NT = 16


def _fn(source: str, name: str, nptr: int, nint: int):
    fn = getattr(_build.load(source), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * nint \
        + [ctypes.c_void_p]
    return fn


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _targets(name, targets, mono):
    if not targets.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors")
    T, L, C = targets.shape
    if L == 0 or C != (1 if mono else 2) or targets.dtype != I32 \
            or not targets.is_contiguous():
        raise ValueError(
            f"{name}: targets must be contiguous int32 (T, L, "
            f"{1 if mono else 2}), got {targets.dtype} "
            f"{tuple(targets.shape)}")
    return T, L, C


def _chain(name, L, dev, terms, deltas, num_terms, w0a, w0b, h0a, h0b):
    return [_as_i32("terms", terms, (L, NT), dev, name),
            _as_i32("deltas", deltas, (L, NT), dev, name),
            _as_i32("w0a", w0a, (L, NT), dev, name),
            _as_i32("w0b", w0b, (L, NT), dev, name),
            _as_i32("h0a", h0a, (L, NT, 8), dev, name),
            _as_i32("h0b", h0b, (L, NT, 8), dev, name),
            _as_i32("num_terms", num_terms, (L,), dev, name)]


def chain_kernel(L: int, mono: bool, static_terms=None) -> tuple[int, str]:
    """The kernel an invert or hybrid launch of L lanes runs for its
    `static_terms`: (chain id, instance name), the chain's own kernel where
    decorr_cuda.lane_runs names one of ENCODE_CHAINS for the whole launch,
    else the run-time kernel (for the decode kernel's own chains too)."""
    ((chain, _lo, _hi),) = lane_runs(L, mono, static_terms)
    if chain >= len(ENCODE_CHAINS):
        chain = GENERIC
    return chain, instance_name(chain, mono)


def invert_instance(instance: str, with_state: bool) -> str:
    """The name of an invert kernel: its chain's instance name
    (chain_kernel), "[state]" added for the kernel that also returns the
    final state."""
    return instance + "[state]" if with_state else instance


# the invert's 20 kernels: each instance, without and with the final state
INVERT_INSTANCES = tuple(invert_instance(n, s) for s in (False, True)
                         for n in ENCODE_INSTANCES)


def decorr_invert_cuda(targets, terms, deltas, num_terms, w0a, w0b, h0a,
                       h0b, *, mono: bool, with_state: bool = False,
                       static_terms=None):
    """Same contract as ops/encode_kernels.py::decorr_invert_warm, on CUDA
    tensors. `static_terms`, when every lane carries that chain, runs its
    compiled kernel where ENCODE_CHAINS has one (wvpk's rule: ignored when
    empty, or on mono with cross terms); the run-time kernel runs
    otherwise."""
    T, L, C = _targets("encode_invert kernel", targets, mono)
    dev = targets.device
    chain, instance = chain_kernel(L, mono, static_terms)
    args = _chain("encode_invert", L, dev, terms, deltas, num_terms, w0a,
                  w0b, h0a, h0b)
    targets = _aligned(targets, C)
    res = torch.empty_like(targets)
    state = [None] * 4
    if with_state:
        state = [torch.empty((L, NT), dtype=I32, device=dev),
                 None if mono else torch.empty((L, NT), dtype=I32,
                                               device=dev),
                 torch.empty((L, NT, 8), dtype=I32, device=dev),
                 None if mono else torch.empty((L, NT, 8), dtype=I32,
                                               device=dev)]
    err = _fn("encode_invert", "wvpk_encode_invert", 13, 6)(
        targets.data_ptr(), *(a.data_ptr() for a in args[:6]),
        args[6].data_ptr(), res.data_ptr(),
        *(None if s is None else s.data_ptr() for s in state), L, T,
        int(mono), int(with_state), chain, dev.index, _stream(dev))
    if err != 0:
        raise RuntimeError(f"encode_invert kernel launch failed: CUDA "
                           f"error {err}")
    decorr_invert_cuda.launches += 1
    decorr_invert_cuda.chain_launches[invert_instance(instance,
                                                      with_state)] += 1
    if not with_state:
        return res
    decorr_invert_cuda.warm_launches += 1
    wa, wb, ha, hb = (None if s is None else s.to(I64) for s in state)
    return res, ((wa, wa, ha, ha) if mono else (wa, wb, ha, hb))


def encode_words_plain(res_words, med0, nvals, *, mono: bool):
    """The plain version of `encode_words_cuda`: entropy_encode_words,
    then the slots and the final flush packed."""
    bits, lens, *pending = entropy_encode_words(res_words, med0, nvals,
                                                mono=mono)
    return pack_segments_device(bits, lens, *pending)


def int64_lanes(med0) -> torch.Tensor:
    """Which lanes the word coders run with int64 medians: a (L,) bool
    tensor, True where a staged median lies outside int32 (never for the
    encoder's quantized medians)."""
    m = med0.to(I64).reshape(med0.shape[0], -1)
    return ((m < -(1 << 31)) | (m >= 1 << 31)).any(-1)


def encode_words_cuda(res_words, med0, nvals, *, mono: bool):
    """Lossless word coding of res_words (W, L) int32 with medians med0
    (L, 2, 3) int64 and valid word counts nvals (L,): (words (L,
    payload_cap(W)) int32, total_bits (L,) int64), as encode_words_plain."""
    if not res_words.is_cuda:
        raise ValueError("encode_words_cuda takes CUDA tensors")
    W, L = res_words.shape
    dev = res_words.device
    if L == 0:
        raise ValueError("encode_words kernel: no lanes")
    _check("res_words", res_words, I32, (W, L), dev, "encode_words")
    _check("med0", med0, I64, (L, 2, 3), dev, "encode_words")
    nv = _as_i32("nvals", nvals, (L,), dev, "encode_words")
    cap = payload_cap(W)
    words = torch.zeros((L, cap), dtype=I32, device=dev)
    total = torch.empty(L, dtype=I64, device=dev)
    wide = torch.zeros(1, dtype=I32, device=dev)
    err = _fn("encode_words", "wvpk_encode_words", 6, 4)(
        res_words.data_ptr(), med0.data_ptr(), nv.data_ptr(),
        words.data_ptr(), total.data_ptr(), wide.data_ptr(), L, W, cap,
        int(mono), _stream(dev))
    if err != 0:
        raise RuntimeError(f"encode_words kernel launch failed: CUDA "
                           f"error {err}")
    encode_words_cuda.launches += 1
    encode_words_cuda.wide_lanes = wide
    return words, total


def hybrid_encode_plain(targets, terms, deltas, num_terms, med0, slow0, acc0,
                        delta0, nvals, w0a, w0b, h0a, h0b, *, mono: bool,
                        hybrid_bitrate: bool, hybrid_balance: bool,
                        static_terms=None):
    """The plain version of `hybrid_encode_cuda`: hybrid_encode_scan, then
    the slots and the final flush packed. Returns (words, total_bits,
    recon). `static_terms` chooses a kernel and changes no result: it is
    taken and ignored."""
    out = hybrid_encode_scan(
        targets, terms, deltas, num_terms, med0, slow0, acc0, delta0, nvals,
        w0a, w0b, h0a, h0b, mono=mono, hybrid_bitrate=hybrid_bitrate,
        hybrid_balance=hybrid_balance)
    return pack_segments_device(*out[:6]) + (out[6],)


def hybrid_encode_cuda(targets, terms, deltas, num_terms, med0, slow0, acc0,
                       delta0, nvals, w0a, w0b, h0a, h0b, *, mono: bool,
                       hybrid_bitrate: bool, hybrid_balance: bool,
                       static_terms=None):
    """The fused hybrid encode on CUDA tensors: (words (L,
    payload_cap(T * C)) int32, total_bits (L,) int64, recon (T, L, C)
    int32), as hybrid_encode_plain. `static_terms`, when every lane
    carries that chain, runs its compiled kernel where ENCODE_CHAINS has one
    (wvpk's rule: ignored when empty, or on mono with cross terms); the
    run-time kernel runs otherwise."""
    T, L, C = _targets("encode_hybrid kernel", targets, mono)
    dev = targets.device
    chain, instance = chain_kernel(L, mono, static_terms)
    args = _chain("encode_hybrid", L, dev, terms, deltas, num_terms, w0a,
                  w0b, h0a, h0b)
    for name, t, shape in (("med0", med0, (L, 2, 3)), ("slow0", slow0, (L, 2)),
                           ("acc0", acc0, (L, 2)), ("delta0", delta0, (L, 2))):
        _check(name, t, I64, shape, dev, "encode_hybrid")
    nv = _as_i32("nvals", nvals, (L,), dev, "encode_hybrid")
    targets = _aligned(targets, C)
    cap = payload_cap(T * C)
    words = torch.zeros((L, cap), dtype=I32, device=dev)
    total = torch.empty(L, dtype=I64, device=dev)
    recon = torch.empty_like(targets)
    wide = torch.zeros(1, dtype=I32, device=dev)
    err = _fn("encode_hybrid", "wvpk_encode_hybrid", 18, 7)(
        targets.data_ptr(), *(a.data_ptr() for a in args), med0.data_ptr(),
        slow0.data_ptr(), acc0.data_ptr(), delta0.data_ptr(), nv.data_ptr(),
        _tables(dev).data_ptr(), words.data_ptr(), total.data_ptr(),
        recon.data_ptr(), wide.data_ptr(), L, T, cap, int(mono),
        int(hybrid_bitrate), int(hybrid_balance), chain, _stream(dev))
    if err != 0:
        raise RuntimeError(f"encode_hybrid kernel launch failed: CUDA "
                           f"error {err}")
    hybrid_encode_cuda.launches += 1
    hybrid_encode_cuda.chain_launches[instance] += 1
    hybrid_encode_cuda.wide_lanes = wide
    return words, total, recon


decorr_invert_cuda.launches = 0
# of `launches`, those with `with_state` (the warm seeding scan)
decorr_invert_cuda.warm_launches = 0
encode_words_cuda.launches = 0
hybrid_encode_cuda.launches = 0
# of `launches`, those of each kernel instantiation (ENCODE_INSTANCES:
# the chains of ENCODE_CHAINS, "generic" and "generic_mono" the run-time
# kernel;
# the invert's with the final state as "<name>[state]", INVERT_INSTANCES)
decorr_invert_cuda.chain_launches = dict.fromkeys(INVERT_INSTANCES, 0)
hybrid_encode_cuda.chain_launches = dict.fromkeys(ENCODE_INSTANCES, 0)
# the last launch's count of lanes coded with int64 medians (int64_lanes),
# a (1,) int32 tensor on its device (0 on staged lanes)
encode_words_cuda.wide_lanes = None
hybrid_encode_cuda.wide_lanes = None
