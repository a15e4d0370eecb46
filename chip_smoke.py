#!/usr/bin/env python3
"""Smoke run of wvpk_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. the card's name and power limit (nvidia-smi, a plain line);
  2. build every CUDA kernel from wvpk_torch/csrc, one nvcc per source, all
     started together;
  3. lossless: each kernel against its plain PyTorch version on the card,
     bit-exact, on a 64-lane slice and at the full bucket (the main path's
     shapes), timed; then the bench corpus (192 files of 4 s 16-bit stereo
     at 44.1 kHz, 16 distinct signals encoded with wvpk.testgen, each
     repeated 12 times) through wvpk_torch.engine.decode_states: one
     warm-up and three timed repeats; 0 CRC errors, 0 mutes, sample-exact
     against the source PCM, the scalar oracle (wvpk.ref) agreeing on
     probe blocks, both kernels launched by that run; one run split into
     its stages;
  4. hybrid lossy, the slice's headline: the 10 hybrid signals of the JAX
     bench (2 s 16-bit stereo, HYBRID_BITRATE, bitrates 256..976, balance
     on every third, two term chains), each repeated 37 times; the hybrid
     entropy kernel against its plain version (stereo with and without
     HYBRID_BALANCE, and a mono bucket), then decode_states as in 3, with
     the oracle as the reference (the decode is lossy: the wv header's CRC
     covers the lossy reconstruction), and a stage split;
  5. hybrid + .wvc: 8 hybrid-lossless pairs, each repeated 46 times; the
     entropy kernel's wvc profile, the correction-stream kernel and the
     decorrelation kernel's wvc arm against their plain versions, then
     decode_states: sample-exact against the source, both CRCs good and
     the corrections applied to every block;
  6. float (8 signals x 9) and int32+wvx (4 files x 18, several sent_bits,
     max_width 0 and 30; the wvx injection kernel against its plain
     version): decode_states sample-exact against the source, 0 CRC
     errors (crc_x included);
  7. `python -m wvpk_torch.cli` on a lossless file, a hybrid file beside
     its .wvc and a float file: each .wav must equal the WAV header plus
     the source samples, byte for byte.
Then a JSON line of per-kernel results and, last, the device JSON line.

Counts of kernel launches are set to 0 just before each decode_states
phase and read just after it; launches made to compare a kernel with its
plain version do not count. Where a plain version would run over a
minute at the full bucket, its time is taken on a 64-lane prefix at full
T and marked so.

Needs one CUDA device; exits non-zero, printing no result, without one or
when any phase fails. Imports no jax. Writes only under build/ in the
checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_DISTINCT, N_FILES, SECONDS, SEED = 16, 192, 4.0, 0
SPEC = dict(block_samples=4096, joint=True, terms=(18, 17, 2),
            deltas=(2, 2, 2))
# copies of the distinct signals in the corpora of phases 4-6
HYBRID_COPIES, WVC_COPIES, FLOAT_COPIES, WVX_COPIES = 37, 46, 9, 18
PCM_SECONDS = 2.0          # length of each phase 4-6 signal
PLAIN_LIMIT_S = 60.0       # a longer plain run is timed on 64 lanes only
# the wvx files: (int32_sent_bits, int32_max_width, amplitude bits); the
# values stay narrower than max_width, so no sent bit is truncated
WVX_FILES = ((4, 0, 27), (6, 30, 28), (8, 0, 29), (5, 30, 27))


def make_corpus(n_distinct=N_DISTINCT, n_files=N_FILES, seconds=SECONDS,
                seed=SEED):
    """The bench headline corpus (bench.py::_generate_corpus's signals):
    `n_distinct` encoded files, repeated to `n_files`. Returns (files,
    pcms), one entry per distinct file; file k of the corpus is
    files[k % n_distinct]."""
    from wvpk.testgen import EncodeSpec, encode_file

    rng = np.random.default_rng(seed)
    n = int(44100 * seconds)
    t = np.arange(n)
    files, pcms = [], []
    for i in range(n_distinct):
        f0 = 220 * (1 + (i % 7))
        sig = (6000 * np.sin(2 * np.pi * f0 * t / 44100)
               + 2500 * np.sin(2 * np.pi * 2.01 * f0 * t / 44100)
               + rng.normal(0, 400, n))
        pcm = np.stack([np.round(sig),
                        np.round(sig * 0.8 + rng.normal(0, 200, n))],
                       axis=1).astype(np.int64)
        np.clip(pcm, -32768, 32767, out=pcm)
        files.append(encode_file(pcm, EncodeSpec(**SPEC)))
        pcms.append(pcm)
    return files, pcms


def _tone_pair(seed, f0, amp, noise, ratio, lim, n):
    """A stereo test signal: a tone plus noise, the second channel a
    scaled copy; clipped to +/- lim."""
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    sig = amp * np.sin(2 * np.pi * f0 * t / 44100) + rng.normal(0, noise, n)
    pcm = np.stack([np.round(sig), np.round(sig * ratio)], 1).astype(
        np.int64)
    np.clip(pcm, -lim, lim - 1, out=pcm)
    return pcm


def make_hybrid(n=None):
    """bench.py::_make_hybrid's 10 signals: 16-bit stereo, block 4096,
    HYBRID_BITRATE at bitrates 256..976, bitrate_delta i % 3, balance on
    i % 3 == 2, two term chains. Returns (files, pcms)."""
    from wvpk.testgen import EncodeSpec, encode_file

    n = n or int(44100 * PCM_SECONDS)
    files, pcms = [], []
    for i in range(10):
        pcm = _tone_pair(800 + i, 200 + 90 * i, 4000 + 900 * i,
                         300 + 120 * i, 0.5 + 0.05 * i, 32768, n)
        spec = EncodeSpec(block_samples=4096, joint=True, hybrid=True,
                          hybrid_bitrate=True, bitrate=256 + 80 * i,
                          bitrate_delta=i % 3, hybrid_balance=(i % 3 == 2),
                          terms=(18, 17, 2) if i % 2 else (18, 18, 2, 17, 3),
                          deltas=(2, 2, 2) if i % 2 else (2,) * 5)
        files.append(encode_file(pcm, spec))
        pcms.append(pcm)
    return files, pcms


def make_mono_hybrid(n=None):
    """Three mono hybrid files (the first channel of three hybrid
    signals), for the mono bucket of the entropy kernel's hybrid
    profile."""
    from wvpk.testgen import EncodeSpec, encode_file

    n = n or int(44100 * PCM_SECONDS)
    files = []
    for i in range(3):
        pcm = _tone_pair(850 + i, 240 + 70 * i, 5000, 400 + 200 * i, 1.0,
                         32768, n)[:, :1]
        files.append(encode_file(pcm, EncodeSpec(
            block_samples=4096, mono=True, hybrid=True,
            hybrid_bitrate=bool(i % 2), bitrate=300 + 200 * i,
            bitrate_delta=i, terms=(18, 2), deltas=(2, 2))))
    return files


def make_wvc(n=None):
    """bench.py::_make_wvc's 8 hybrid-lossless signals, encoded with
    wvpk.testgen (not wvpk.encode) to the specs wvpk.encode gives them:
    HYBRID_BITRATE at bitrates 256..970, the fast (17, 17) and default
    (18, 18, 2, 17, 3) chains in turn. Returns ([(wv, wvc)], pcms)."""
    from wvpk.testgen import EncodeSpec
    from wvpk.testgen.encoder import encode_blocks

    n = n or int(44100 * PCM_SECONDS)
    pairs, pcms = [], []
    for i in range(8):
        pcm = _tone_pair(1100 + i, 220 + 100 * i, 4500 + 700 * i,
                         250 + 140 * i, 0.5 + 0.05 * i, 32768, n)
        terms, deltas = ((17, 17), (2, 2)) if i % 2 else \
            ((18, 18, 2, 17, 3), (2,) * 5)
        spec = EncodeSpec(block_samples=4096, joint=True, hybrid=True,
                          hybrid_bitrate=True, bitrate=256 + 102 * i,
                          wvc=True, terms=terms, deltas=deltas)
        sink: list = []
        wv = b"".join(encode_blocks(pcm, spec, wvc_sink=sink))
        pairs.append((wv, b"".join(sink)))
        pcms.append(pcm)
    return pairs, pcms


def make_float(n=None):
    """bench.py::_make_float's 8 signals: FLOAT_DATA on the grids
    norm_exp 127 and 130 (decoded-int domain, 24-bit), two term chains.
    Returns (files, pcms, norm_exps)."""
    from wvpk.testgen import EncodeSpec, encode_file

    n = n or int(44100 * PCM_SECONDS)
    files, pcms, exps = [], [], []
    for i in range(8):
        pcm = _tone_pair(900 + i, 260 + 110 * i, (2 << 20) * (1 + i % 3),
                         20000 * (1 + i), 0.4 + 0.06 * i, (1 << 23) - 1, n)
        exp = 127 + 3 * (i % 2)
        files.append(encode_file(pcm, EncodeSpec(
            block_samples=4096, joint=True, float_data=True, bytes_stored=4,
            float_shift=0, float_max_exp=exp, float_norm_exp=exp,
            terms=(18, 17, 2) if i % 2 else (18, 18, 2, 17, 3),
            deltas=(2, 2, 2) if i % 2 else (2,) * 5)))
        pcms.append(pcm)
        exps.append(exp)
    return files, pcms, exps


def make_wvx(i, n=None):
    """int32+wvx file `i` of WVX_FILES: 32-bit stereo whose low
    int32_sent_bits bits travel in the wvx stream. The testgen wvx encoder
    is pure Python (~4 s a file), so the files encode in worker
    processes. Returns (file, pcm)."""
    from wvpk.testgen import EncodeSpec, encode_file

    n = n or int(44100 * PCM_SECONDS)
    sent, max_width, amp = WVX_FILES[i]
    pcm = _tone_pair(1300 + i, 300 + 150 * i, 2 ** amp, 1 << (amp - 6),
                     0.6 - 0.1 * i, 1 << 31, n)
    return encode_file(pcm, EncodeSpec(
        block_samples=4096, joint=bool(i % 2), bytes_stored=4,
        int32_mode="wvx", int32_sent_bits=sent, int32_max_width=max_width,
        terms=(18, 17, 2), deltas=(2, 2, 2))), pcm


def parse_corpus(files, n_files):
    """Block states of every corpus file (each copy parsed on its own, so
    every lane has its own state) and the block count per file. A file
    given as (wv, wvc) has its correction file paired."""
    from wvpk.container import parse_blocks
    from wvpk.container.blocks import pair_wvc

    states, per_file = [], []
    for k in range(n_files):
        f = files[k % len(files)]
        if isinstance(f, tuple):
            blocks = parse_blocks(f[0])
            pair_wvc(blocks, f[1])
        else:
            blocks = parse_blocks(f)
        states += [b.state for b in blocks]
        per_file.append(len(blocks))
    return states, per_file


def _sync():
    torch.cuda.synchronize()


def _max_abs_err(want, got) -> int:
    if want.numel() == 0:
        return 0
    return int((want.to(torch.int64) - got.to(torch.int64)).abs().max())


def _events_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA
    events around the run)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_pair(name, kernel, plain, args, kw, timed, run_plain=True):
    """`kernel` against `plain` on the same inputs; raises on any
    difference. Returns (the kernel's outputs, {max_abs_err, ms,
    plain_ms}); ms (5 launches, CUDA events) only when `timed`, the plain
    version timed once on the host clock and left out (None) when not
    `run_plain`."""
    got = kernel(*args, **kw)
    _sync()
    res = {"max_abs_err": None, "ms": None, "plain_ms": None}
    if run_plain:
        t0 = time.perf_counter()
        want = plain(*args, **kw)
        _sync()
        res["plain_ms"] = 1000 * (time.perf_counter() - t0)
        for i, (w, g) in enumerate(zip(want, got)):
            if not torch.equal(w, g):
                raise AssertionError(
                    f"{name} kernel != plain version: output {i}")
        res["max_abs_err"] = max(_max_abs_err(w, g)
                                 for w, g in zip(want, got))
    if timed:
        res["ms"] = _events_ms(lambda: kernel(*args, **kw), 5)
    return got, res


def _kernels():
    """The kernel wrappers and their plain versions, by name."""
    from wvpk_torch.ops import decorr, decorr_cuda, entropy, entropy_cuda, \
        post, wvc_cuda, wvx_cuda

    return {
        "entropy": (entropy_cuda.entropy_decode_cuda,
                    entropy.entropy_decode),
        "entropy_wvc": (entropy_cuda.entropy_decode_wvc_cuda,
                        lambda *a, **k: entropy.entropy_decode(
                            *a, hybrid=True, wvc=True, **k)),
        "decorr": (decorr_cuda.decorr_post_cuda, decorr.decorr_post),
        "decorr_wvc": (decorr_cuda.decorr_post_wvc_cuda,
                       decorr.decorr_post_wvc),
        "wvc": (wvc_cuda.wvc_corrections_cuda, entropy.wvc_corrections),
        "wvx": (wvx_cuda.wvx_inject_cuda, post.wvx_inject),
    }


def _entropy_io(t, prof):
    args = (t["words"], t["nwords_lane"], t["med"], t["slow"], t["acc"],
            t["delta"])
    kw = dict(mono=prof.mono, nsteps=prof.nsteps,
              hybrid_bitrate=prof.hybrid_bitrate,
              hybrid_balance=prof.hybrid_balance)
    return args, kw


def _decorr_args(t, residuals):
    return (residuals, t["terms"], t["deltas16"], t["wa"], t["wb"],
            t["hist_a"], t["hist_b"], t["num_terms"], t["nsamples"],
            t["joint"], t["mute_limit"])


def compare_bucket(bucket, device, timed, run_plain=True):
    """Each kernel of the bucket's decode against its plain version on
    the same inputs (the kernels' outputs feed the next step): lossless
    buckets run the entropy and decorrelation kernels, hybrid buckets the
    entropy kernel's hybrid profile, wvc buckets the entropy kernel's wvc
    profile, the correction scan and the decorrelation kernel's wvc arm,
    wvx buckets the wvx injection (its entropy and decorrelation kernels
    only feed it: the lossless phase holds them). Returns {kernel name:
    {max_abs_err, ms, plain_ms}}."""
    from wvpk_torch.engine.staging import bucket_tensors
    from wvpk_torch.ops.post import mask_muted

    k = _kernels()
    t = bucket_tensors(bucket, device)
    prof = bucket.profile
    args, kw = _entropy_io(t, prof)
    out = {}
    if prof.has_wvc:
        (res, mc, base, broke, _), out["entropy_wvc"] = check_pair(
            "entropy[hybrid_wvc]", *k["entropy_wvc"], args, kw, timed,
            run_plain)
        corr, out["wvc"] = check_pair(
            "wvc_corrections", *k["wvc"], (t["wvc_words"], mc, base, res),
            {}, timed, run_plain)
        dargs = _decorr_args(t, res)
        _, out["decorr_wvc"] = check_pair(
            "decorr_post[wvc]", *k["decorr_wvc"],
            dargs[:1] + (corr,) + dargs[1:], dict(mono=prof.mono), timed,
            run_plain)
    else:
        hold = not prof.has_wvx
        (res, broke, _), ent = check_pair(
            "entropy", *k["entropy"], args, dict(kw, hybrid=prof.hybrid),
            timed and hold, run_plain and hold)
        if hold:
            out["entropy"] = ent
        if not prof.hybrid:
            (dec, _crc, first_bad), dres = check_pair(
                "decorr_post", *k["decorr"], _decorr_args(t, res),
                dict(mono=prof.mono), timed and hold, run_plain and hold)
            if hold:
                out["decorr"] = dres
    if broke.any():
        raise AssertionError("corpus lanes hit an EOF break")
    if prof.has_wvx:
        dec, _ = mask_muted(dec, t["nsamples"], broke, first_bad)
        fs = t["false_stereo"] if t["false_stereo"].any() else None
        _, out["wvx"] = check_pair(
            "wvx_inject", *k["wvx"],
            (dec, t["nsamples"], t["wvx_words"], t["wvx_start_bit"],
             t["wvx_start_bc"], t["sent_bits"], t["max_width"],
             t["int32_zod"], fs), {}, timed, run_plain)
    return out


def compare_phase(name, states, device, slice_of=None):
    """compare_bucket on a 64-lane slice, then at the phase's largest
    bucket (the main path's shape), timed. The slice comes from that
    bucket, or from the bucket `slice_of(buckets)` picks. A plain version
    that took over PLAIN_LIMIT_S on the 64 lanes is not run again at the
    full bucket: its time and check stay the 64-lane ones (marked by
    plain_lanes)."""
    from wvpk_torch.engine.staging import group_blocks

    buckets = group_blocks(states)
    b = max(buckets, key=lambda x: len(x.states))
    src = slice_of(buckets) if slice_of else b
    slice64 = compare_bucket(group_blocks(src.states[:64])[0], device, False)
    print(json.dumps({"phase": f"{name}_kernels_vs_plain_64_lanes",
                      "profile": _profile_name(src.profile),
                      "results": slice64}))
    slow = [k for k, v in slice64.items()
            if v["plain_ms"] > 1000 * PLAIN_LIMIT_S]
    full = compare_bucket(b, device, True, run_plain=not slow)
    for k in full:
        full[k]["plain_lanes"] = len(b.states)
        if slow:
            full[k]["plain_ms"] = slice64[k]["plain_ms"]
            full[k]["max_abs_err"] = slice64[k]["max_abs_err"]
            full[k]["plain_lanes"] = 64
    print(json.dumps({"phase": f"{name}_kernels_vs_plain_full_bucket",
                      "profile": _profile_name(b.profile),
                      "buckets": [len(x.states) for x in buckets],
                      "lanes": len(b.states), "T": b.profile.nsamples_cap,
                      "words_per_lane": int(b.words.shape[1]),
                      "results": full}))
    return full


def _profile_name(prof) -> str:
    parts = ["mono" if prof.mono else "stereo"]
    for flag, word in ((prof.hybrid, "hybrid"),
                       (prof.hybrid_bitrate, "HYBRID_BITRATE"),
                       (prof.hybrid_balance, "HYBRID_BALANCE"),
                       (prof.is_float, "float"), (prof.is_int32, "int32"),
                       (prof.has_wvx, "wvx"), (prof.has_wvc, "wvc")):
        if flag:
            parts.append(word)
    return " ".join(parts)


def _counters():
    from wvpk_torch.ops import decorr_cuda, entropy_cuda, wvc_cuda, wvx_cuda

    return {"entropy": entropy_cuda.entropy_decode_cuda,
            "entropy_wvc": entropy_cuda.entropy_decode_wvc_cuda,
            "decorr": decorr_cuda.decorr_post_cuda,
            "decorr_wvc": decorr_cuda.decorr_post_wvc_cuda,
            "wvc": wvc_cuda.wvc_corrections_cuda,
            "wvx": wvx_cuda.wvx_inject_cuda}


def decode_phase(name, states, frames, device, expect, check):
    """decode_states on the phase's corpus: every launch count set to 0,
    one warm-up and three timed calls, the counts read; each kernel in
    `expect` must have launched. `check(results)` raises on a wrong
    result and returns a dict for the phase line."""
    from wvpk_torch.engine import decode_states

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rates = []
    results = None
    for rep in range(4):
        # a caller consumes each call's output before the next: holding
        # the previous results while the next call allocates its own
        # slowed finalize 2-4x on the card's host
        results = None
        t0 = time.perf_counter()
        results = decode_states(states, device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rep > 0:
            rates.append(frames / dt / 1e6)
    launches = {k: fn.launches for k, fn in counters.items()}
    if min(launches[k] for k in expect) < 1:
        raise AssertionError(f"{name}: main path skipped a kernel: "
                             f"{launches}")
    info = check(results)
    print(json.dumps({"phase": f"{name}_decode_states", "warmup": 1,
                      "msamples_per_s": rates, "frames": frames,
                      "blocks": len(states), **info, "launches": launches,
                      "peak_device_bytes":
                          torch.cuda.max_memory_allocated()}))
    return launches


def _flags(results, want_wvc=False):
    crc_errors = sum(r.crc_error for r in results)
    mutes = sum(r.mute_error for r in results)
    if crc_errors or mutes:
        raise AssertionError(f"{crc_errors} CRC errors, {mutes} mutes")
    if want_wvc and not all(r.wvc_applied for r in results):
        raise AssertionError("a block decoded without its corrections")
    return {"crc_errors": crc_errors, "mutes": mutes}


def _probe(results, states, per_file):
    """The scalar oracle on a few blocks: first, a file's last, middle,
    last of all."""
    from wvpk.ref import decode_block

    probe = sorted({0, per_file[0] - 1, len(states) // 2, len(states) - 1})
    for i in probe:
        want = decode_block(states[i])
        if not np.array_equal(want.samples, results[i].samples):
            raise AssertionError(f"oracle disagrees on block {i}")
    return len(probe)


def _exact(results, per_file, pcms):
    pos = 0
    for k, nblk in enumerate(per_file):
        got = np.concatenate([r.samples for r in results[pos:pos + nblk]])
        if not np.array_equal(got, pcms[k % len(pcms)]):
            raise AssertionError(f"file {k} is not sample-exact")
        pos += nblk


def check_exact(states, per_file, pcms, want_wvc=False, probe=True):
    """0 CRC errors, 0 mutes, every file sample-exact against its source
    PCM and (if `probe`) the scalar oracle agreeing on probe blocks."""
    def check(results):
        info = _flags(results, want_wvc)
        _exact(results, per_file, pcms)
        info["sample_exact"] = True
        if probe:
            info["oracle_blocks"] = _probe(results, states, per_file)
        return info
    return check


def check_oracle(states, per_file):
    """The lossy hybrid decode: 0 CRC errors (the wv header's CRC covers
    the lossy reconstruction), 0 mutes, the oracle agreeing on probe
    blocks."""
    def check(results):
        info = _flags(results)
        info["oracle_blocks"] = _probe(results, states, per_file)
        return info
    return check


def stage_breakdown(states, device):
    """One decode split into its stages, each closed by a synchronize:
    seconds per stage."""
    from wvpk_torch.engine import pipeline
    from wvpk_torch.engine.fused import deliver
    from wvpk_torch.engine.staging import bucket_tensors, group_blocks

    marks = {}
    t0 = time.perf_counter()

    def mark(name):
        nonlocal t0
        if device.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        marks[name] = marks.get(name, 0.0) + now - t0
        t0 = now

    buckets = group_blocks(states)
    mark("staging")
    launched = []
    for b in buckets:
        t = bucket_tensors(b, device)
        mark("h2d")
        out, crc, mute, crc_x, crc_wvc = pipeline.decode_tensors(b, t)
        mark("decode_kernels")
        bps = pipeline._bucket_bps(b)
        payload, crcmute = deliver(out, crc, mute, bps, crc_x=crc_x,
                                   crc_wvc=crc_wvc)
        mark("pack")
        launched.append(pipeline.LaunchedBucket(b, payload, crcmute, bps))
    fetched = pipeline._fetch_arrays(
        [a for lb in launched for a in (lb.crcmute, lb.payload)])
    mark("d2h")
    for k, lb in enumerate(launched):
        pipeline.finalize_bucket(lb, fetched[2 * k], fetched[2 * k + 1])
    mark("finalize")
    return marks


def run_cli(files, device):
    """The CLI on several files in one process: `files` maps a name to
    (.wv bytes, .wvc bytes or None, expected .wav bytes). Each .wav must
    equal its expected bytes."""
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    paths = []
    for name, (wv, wvc, _want) in files.items():
        src = os.path.join(work, name + ".wv")
        with open(src, "wb") as f:
            f.write(wv)
        if wvc is not None:
            with open(src + "c", "wb") as f:
                f.write(wvc)
        paths.append(src)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "wvpk_torch.cli", *paths, "-q", "--device",
         str(device)], cwd=REPO, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"CLI exited {proc.returncode}: {proc.stderr}")
    for name, (_wv, _wvc, want) in files.items():
        with open(os.path.join(work, name + ".wav"), "rb") as f:
            if f.read() != want:
                raise AssertionError(f"CLI .wav of {name} differs from "
                                     "the header + source samples")
    return secs


def _frames(pcms, n_files):
    return sum(len(pcms[k % len(pcms)]) for k in range(n_files))


def _corpus_line(name, files, n_files, states, frames, t0):
    nbytes = sum(len(f[0]) + len(f[1]) if isinstance(f, tuple) else len(f)
                 for f in (files[k % len(files)] for k in range(n_files)))
    print(json.dumps({"phase": f"{name}_corpus", "files": n_files,
                      "distinct": len(files), "blocks": len(states),
                      "frames": frames, "bytes": nbytes,
                      "seconds": time.perf_counter() - t0}))


def phase_lossless(dev):
    t0 = time.perf_counter()
    files, pcms = make_corpus()
    states, per_file = parse_corpus(files, N_FILES)
    frames = _frames(pcms, N_FILES)
    _corpus_line("lossless", files, N_FILES, states, frames, t0)
    full = compare_phase("lossless", states, dev)
    launches = decode_phase("lossless", states, frames, dev,
                            ("entropy", "decorr"),
                            check_exact(states, per_file, pcms))
    print(json.dumps({"phase": "lossless_stage_seconds",
                      "stages": stage_breakdown(states, dev)}))
    return full, launches, (files[0], pcms[0])


def phase_hybrid(dev):
    from wvpk_torch.engine.staging import group_blocks

    t0 = time.perf_counter()
    files, pcms = make_hybrid()
    states, per_file = parse_corpus(files, len(files) * HYBRID_COPIES)
    frames = _frames(pcms, len(files) * HYBRID_COPIES)
    _corpus_line("hybrid", files, len(files) * HYBRID_COPIES, states,
                 frames, t0)
    # the 64-lane slice takes the HYBRID_BALANCE bucket, the full bucket
    # is the largest (HYBRID_BITRATE alone): both profiles are held
    full = compare_phase(
        "hybrid", states, dev, slice_of=lambda buckets: next(
            b for b in buckets if b.profile.hybrid_balance))
    mono_states, _ = parse_corpus(make_mono_hybrid(), 3)
    mono = compare_bucket(max(group_blocks(mono_states),
                              key=lambda x: len(x.states)), dev, True)
    print(json.dumps({"phase": "hybrid_mono_kernels_vs_plain",
                      "lanes": len(mono_states), "results": mono}))
    launches = decode_phase("hybrid", states, frames, dev,
                            ("entropy", "decorr"),
                            check_oracle(states, per_file))
    print(json.dumps({"phase": "hybrid_stage_seconds",
                      "stages": stage_breakdown(states, dev)}))
    return full, launches


def phase_wvc(dev):
    t0 = time.perf_counter()
    pairs, pcms = make_wvc()
    states, per_file = parse_corpus(pairs, len(pairs) * WVC_COPIES)
    frames = _frames(pcms, len(pairs) * WVC_COPIES)
    _corpus_line("wvc", pairs, len(pairs) * WVC_COPIES, states, frames, t0)
    full = compare_phase("wvc", states, dev)
    launches = decode_phase(
        "wvc", states, frames, dev, ("entropy_wvc", "wvc", "decorr_wvc"),
        check_exact(states, per_file, pcms, want_wvc=True, probe=False))
    return full, launches, (pairs[0], pcms[0])


def phase_float_wvx(dev, wvx_futures):
    t0 = time.perf_counter()
    files, pcms, exps = make_float()
    states, per_file = parse_corpus(files, len(files) * FLOAT_COPIES)
    frames = _frames(pcms, len(files) * FLOAT_COPIES)
    _corpus_line("float", files, len(files) * FLOAT_COPIES, states, frames,
                 t0)
    decode_phase("float", states, frames, dev, ("entropy", "decorr"),
                 check_exact(states, per_file, pcms, probe=False))
    float_file = (files[0], pcms[0], exps[0])

    t0 = time.perf_counter()
    wvx = [f.result() for f in wvx_futures]
    files, pcms = [w[0] for w in wvx], [w[1] for w in wvx]
    states, per_file = parse_corpus(files, len(files) * WVX_COPIES)
    frames = _frames(pcms, len(files) * WVX_COPIES)
    _corpus_line("wvx", files, len(files) * WVX_COPIES, states, frames, t0)
    full = compare_phase("wvx", states, dev)
    launches = decode_phase("wvx", states, frames, dev,
                            ("entropy", "decorr", "wvx"),
                            check_exact(states, per_file, pcms, probe=False))
    return full, launches, float_file


def _wav(pcm, bits, nbytes, fmt_tag=1, body=None):
    from wvpk.io.wav import make_wav_header

    hdr = make_wav_header(len(pcm), pcm.shape[1], 44100, bits, nbytes,
                          fmt_tag=fmt_tag)
    return hdr + (body if body is not None else pcm.astype("<i2").tobytes())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from wvpk_torch import _build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "stack frame" in ln
                 or "Compiling entry" in ln]
             for k, v in _build.ptxas_log.items()}
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "nvcc_seconds": _build.build_seconds,
                      "ptxas": ptxas}))

    # the wvx files encode in worker processes while the card works
    with ProcessPoolExecutor(
            max_workers=len(WVX_FILES),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        wvx_futures = [pool.submit(make_wvx, i) for i in range(len(WVX_FILES))]
        lossless, l_launches, (l_file, l_pcm) = phase_lossless(dev)
        hybrid, h_launches = phase_hybrid(dev)
        wvc, c_launches, ((c_wv, c_wvc), c_pcm) = phase_wvc(dev)
        wvx, x_launches, (f_file, f_pcm, f_exp) = phase_float_wvx(
            dev, wvx_futures)

    from wvpk.io.pcm import format_samples

    cli_s = run_cli({
        "lossless": (l_file, None, _wav(l_pcm, 16, 2)),
        "hybrid_wvc": (c_wv, c_wvc, _wav(c_pcm, 16, 2)),
        "float": (f_file, None, _wav(f_pcm, 32, 4, fmt_tag=3,
                                     body=format_samples(
                                         f_pcm, 4, float_norm_exp=f_exp)))},
        dev)
    print(json.dumps({"phase": "cli", "files": 3, "byte_exact": True,
                      "seconds": cli_s}))

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")

    rows = [
        ("entropy_decode[lossless]", "entropy.cu", "entropy_pallas.py:115",
         l_launches["entropy"], lossless["entropy"]),
        ("entropy_decode[hybrid]", "entropy.cu", "entropy_pallas.py:115",
         h_launches["entropy"], hybrid["entropy"]),
        ("entropy_decode[hybrid_wvc]", "entropy.cu", "entropy_pallas.py:115",
         c_launches["entropy_wvc"], wvc["entropy_wvc"]),
        ("decorr_post", "decorr.cu", "decorr_pallas.py:163",
         l_launches["decorr"], lossless["decorr"]),
        ("decorr_post[wvc]", "decorr.cu", "decorr_pallas.py:163",
         c_launches["decorr_wvc"], wvc["decorr_wvc"]),
        ("wvx_inject", "wvx.cu", "post.py:145", x_launches["wvx"],
         wvx["wvx"]),
        ("wvc_corrections", "wvc.cu", "entropy.py:352", c_launches["wvc"],
         wvc["wvc"]),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"wvpk_torch/csrc/{src}",
         "replaces": f"wvpk/ops/{rep}", "launches": n,
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]}
        for name, src, rep, n, r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
