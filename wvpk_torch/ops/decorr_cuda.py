"""Wrapper of the CUDA decorrelation kernels (csrc/decorr.cu).

The kernels replace wvpk/ops/decorr_pallas.py::_decorr_kernel with
fold_post; their plain version is ops/decorr.py::decorr_post, with the
same arguments and results. `decorr_post_wvc_cuda` is their wvc arm, whose
plain version is ops/decorr.py::decorr_post_wvc. Given `pack`,
`decorr_post_cuda` runs their packed store, which writes the bucket's
delivered payload itself (plain version ops/decorr.py::decorr_post_packed).

csrc/decorr.cu compiles one kernel for each chain of CHAINS (its terms
fixed, so its weights and history rings live in registers; a chain past
the encoder's, WavPack's 16-term very high mode, on a cluster of four
CTAs, each a stage of the chain on an SM of its own) and a generic kernel
that reads each lane's chain at run time. A call splits the bucket's lanes
into runs by chain, as wvpk's decorr_post_any does with `static_terms` and
`chain_segments`, and launches each run's kernel on its
lane range: the first run on the caller's stream, the others on side
streams forked from it and joined back into it, so that the runs of a
mixed bucket share the card. The lanes of a run
named by `static_terms` or `chain_segments` must carry that chain (staging
guarantees it).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, consts
from ..device import side_streams

I32 = torch.int32
_INT32_MAX = (1 << 31) - 1

# The chains csrc/decorr.cu compiles, by id: the WVPK_CHAIN lines of
# csrc/decorr_pass.cuh name the same (id, mono, terms) in the same order,
# and a test holds them equal. First WVPK_CHAIN_TABLE's, which the encode
# kernels compile too (ENCODE_CHAINS): the bench chain and the encoder
# presets (encode.PRESETS). Then WVPK_DECODE_CHAIN_TABLE's, the decode
# kernel's alone: the 16 terms of WavPack's very high mode (wavpack -hh),
# which the encoder does not write. Mono chains are the stereo ones
# without their cross-channel terms, as the encoders write them.
CHAINS = (
    ("bench", False, (18, 17, 2)),
    ("fast", False, (17, 17)),
    ("default", False, (18, 18, 2, 17, 3)),
    ("high", False, (18, 18, 18, -2, 2, 3, 5, -1, 17, 4)),
    ("bench_mono", True, (18, 17, 2)),
    ("fast_mono", True, (17, 17)),
    ("default_mono", True, (18, 18, 2, 17, 3)),
    ("high_mono", True, (18, 18, 18, 2, 3, 5, 17, 4)),
    ("very_high", False,
     (18, 18, 2, 3, -2, 18, 2, 4, 7, 5, 3, 6, 8, -1, 18, 2)),
    ("very_high_mono", True, (18, 18, 2, 3, 18, 2, 4, 7, 5, 3, 6, 8, 18, 2)),
)
ENCODE_CHAINS = CHAINS[:8]
GENERIC = -1        # the id of the generic kernel
# the ids whose kernel is the cluster kernel (WVPK_DECODE_CHAIN_TABLE's)
CLUSTER = frozenset(range(len(ENCODE_CHAINS), len(CHAINS)))
_IDS = {(mono, terms): k for k, (_name, mono, terms) in enumerate(CHAINS)}
# the kernels' names, as the launch counters key them
INSTANCES = tuple(name for name, _m, _t in CHAINS) + ("generic",
                                                     "generic_mono")
ENCODE_INSTANCES = tuple(name for name, _m, _t in ENCODE_CHAINS) + (
    "generic", "generic_mono")


def instance_name(chain_id: int, mono: bool) -> str:
    if chain_id == GENERIC:
        return "generic_mono" if mono else "generic"
    return CHAINS[chain_id][0]


def lane_runs(L: int, mono: bool, static_terms=None, chain_segments=None
              ) -> list[tuple[int, int, int]]:
    """The (chain id, start, stop) runs of a bucket's L lanes: the whole
    bucket when `static_terms` names its chain (wvpk's rule: ignored when
    empty or, on a mono bucket, with cross-channel terms), the runs of
    `chain_segments` ((chain or None, start, stop, num_terms_max), ...)
    otherwise, else one generic run. A chain outside CHAINS runs the
    generic kernel."""
    if static_terms is not None and (
            len(static_terms) == 0
            or (mono and any(t < 0 for t in static_terms))):
        static_terms = None
    if static_terms is not None:
        runs = [(tuple(static_terms), 0, L)]
    elif chain_segments:
        runs = [(None if c is None else tuple(c), s, e)
                for c, s, e, *_ in chain_segments]
    else:
        runs = [(None, 0, L)]
    merged: list[tuple[int, int, int]] = []
    pos = 0
    for c, s, e in runs:
        if s != pos or e < s:
            raise ValueError(f"decorr kernel: lane runs {runs} do not "
                             f"tile {L} lanes")
        pos = e
        cid = GENERIC if c is None else _IDS.get((mono, c), GENERIC)
        if merged and merged[-1][0] == cid:     # one run per kernel
            merged[-1] = (cid, merged[-1][1], e)
        elif e > s:
            merged.append((cid, s, e))
    if pos != L:
        raise ValueError(f"decorr kernel: lane runs {runs} do not tile "
                         f"{L} lanes")
    return merged


def _lib() -> ctypes.CDLL:
    lib = _build.load("decorr")
    fn = lib.wvpk_decorr_post
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    lib.wvpk_decorr_ctas.restype = ctypes.c_int
    lib.wvpk_decorr_ctas.argtypes = [ctypes.c_int] * 5
    probe = lib.wvpk_decorr_cluster_probe
    probe.restype = ctypes.c_int
    probe.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
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
            num_terms, nsamples, joint, mute_limit, *, mono: bool, runs,
            pack=None):
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
    # the kernels copy a lane's C values of a step with one cp.async of
    # 4 C bytes, which must be aligned to its size (a fresh tensor is)
    if residuals.data_ptr() % (4 * C):
        residuals = residuals.clone()
    if wvc and corr.data_ptr() % (4 * C):
        corr = corr.clone()
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
    bps, packed = 0, [None] * 2
    if pack is not None:
        bps = pack.bps
        if wvc or bps not in (1, 2, 3) or T * C * bps % 4:
            raise ValueError(
                f"decorr kernel: no packed store at {bps} bytes a sample "
                f"for {T} x {C} values{' with corrections' if wvc else ''}")
        packed = [_as_i32(name, x, (L,), dev) for name, x in (
            ("broke", pack.broke), ("shift", pack.shift))]
        out = torch.empty((L, T * C * bps // 4), dtype=I32, device=dev)
    else:
        out = torch.empty((T, L, C), dtype=I32, device=dev)
    crc = torch.empty(L, dtype=I32, device=dev)
    crc_wvc = torch.empty(L, dtype=I32, device=dev) if wvc else None
    first_bad = torch.empty(L, dtype=I32, device=dev)
    ptrs = (residuals.data_ptr(), corr.data_ptr() if wvc else None,
            *(a.data_ptr() for a in args), out.data_ptr(), crc.data_ptr(),
            crc_wvc.data_ptr() if wvc else None, first_bad.data_ptr(),
            *(None if a is None else a.data_ptr() for a in packed), L, T,
            int(mono), int(wvc), bps, int(pack is not None and pack.hybrid))
    # fork every side stream before the first launch, or a side stream
    # would wait for the runs launched before it
    main = torch.cuda.current_stream(dev)
    side = side_streams(dev, len(runs) - 1)
    for stream in side:
        stream.wait_stream(main)
    for stream, (chain, lo, hi) in zip([main] + side, runs):
        err = _lib().wvpk_decorr_post(*ptrs, chain, lo, hi,
                                      stream.cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"decorr kernel launch failed: CUDA error {err}")
    for stream in side:
        main.wait_stream(stream)
    return out, crc, crc_wvc, first_bad


def _count(fn, runs, mono):
    """One launch of `fn`, and one of each kernel instantiation it ran."""
    fn.launches += 1
    for chain_id, _s, _e in runs:
        fn.chain_launches[instance_name(chain_id, mono)] += 1


def decorr_post_cuda(residuals, terms, deltas, w0_a, w0_b, hist0_a, hist0_b,
                     num_terms, nsamples, joint, mute_limit, *, mono: bool,
                     static_terms=None, chain_segments=None, pack=None):
    """Same contract as ops/decorr.py::decorr_post, on CUDA tensors;
    `static_terms` / `chain_segments` choose the kernels (lane_runs).
    Given `pack` (ops/decorr.py::Pack), the kernels' packed store: the
    contract of ops/decorr.py::decorr_post_packed, the payload in place of
    the samples."""
    runs = lane_runs(residuals.shape[1], mono, static_terms, chain_segments)
    out, crc, _, first_bad = _launch(
        residuals, None, terms, deltas, w0_a, w0_b, hist0_a, hist0_b,
        num_terms, nsamples, joint, mute_limit, mono=mono, runs=runs,
        pack=pack)
    _count(decorr_post_cuda, runs, mono)
    return out, crc, first_bad


def decorr_post_wvc_cuda(residuals, corr, terms, deltas, w0_a, w0_b,
                         hist0_a, hist0_b, num_terms, nsamples, joint,
                         mute_limit, *, mono: bool, static_terms=None,
                         chain_segments=None):
    """Same contract as ops/decorr.py::decorr_post_wvc, on CUDA
    tensors; `static_terms` / `chain_segments` as decorr_post_cuda's."""
    runs = lane_runs(residuals.shape[1], mono, static_terms, chain_segments)
    out = _launch(residuals, corr, terms, deltas, w0_a, w0_b, hist0_a,
                  hist0_b, num_terms, nsamples, joint, mute_limit, mono=mono,
                  runs=runs)
    _count(decorr_post_wvc_cuda, runs, mono)
    return out


# launches of each wrapper, and of each kernel instantiation (INSTANCES)
# in them
for _fn in (decorr_post_cuda, decorr_post_wvc_cuda):
    _fn.launches = 0
    _fn.chain_launches = dict.fromkeys(INSTANCES, 0)


def cluster_sms(L: int, mono: bool, device, wvc: bool = False,
                bps: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """The SM (%smid) of each CTA of a launch in the shape of the very
    high chain's cluster kernel on L lanes (its CTAs, threads and dynamic
    shared memory, `wvc` and `bps` as decorr_post_cuda's), and whether
    each saw every CTA of the launch resident at once: a probe kernel in
    that shape, run to check that no two CTAs of a launch share an SM."""
    chain = len(ENCODE_CHAINS) + (1 if mono else 0)
    n = _lib().wvpk_decorr_ctas(chain, int(mono), int(wvc), bps, L)
    sm = torch.full((n,), -1, dtype=I32, device=device)
    seen = torch.zeros(n, dtype=I32, device=device)
    resident = torch.zeros(1, dtype=I32, device=device)
    err = _lib().wvpk_decorr_cluster_probe(
        chain, int(mono), int(wvc), bps, L, sm.data_ptr(), seen.data_ptr(),
        resident.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cluster probe launch failed: CUDA error {err}")
    return sm, seen.bool()
