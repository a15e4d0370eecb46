#!/usr/bin/env python3
"""Smoke run of wvpk_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line:
  1. the card's name and power limit (nvidia-smi);
  2. build both CUDA kernels from wvpk_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version on the card, bit-exact,
     on a 64-lane slice of the corpus;
  4. the same at the full corpus bucket (the main path's shapes), timed:
     kernel vs plain version;
  5. the bench corpus (192 files of 4 s 16-bit stereo at 44.1 kHz, 16
     distinct signals encoded with wvpk.testgen, each repeated 12 times)
     through wvpk_torch.engine.decode_states: one warm-up and three timed
     repeats; 0 CRC errors, 0 mutes, sample-exact against the source PCM,
     the scalar oracle (wvpk.ref) agreeing on a few blocks, and both
     kernels launched by that run; then one run split into its stages;
  6. `python -m wvpk_torch.cli` on one file: the .wav must equal the WAV
     header plus the source PCM, byte for byte.
Then a JSON line of per-kernel results and, last, the device JSON line.

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


def parse_corpus(files, n_files):
    """Block states of every corpus file (each copy parsed on its own, so
    every lane has its own state) and the block count per file."""
    from wvpk.container import parse_blocks

    states, per_file = [], []
    for k in range(n_files):
        blocks = parse_blocks(files[k % len(files)])
        states += [b.state for b in blocks]
        per_file.append(len(blocks))
    return states, per_file


def _max_abs_err(want, got) -> int:
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


def compare_kernels(bucket, device, timed: bool):
    """Each kernel against its plain version on the same inputs; raises on
    any difference. Returns {name: (max_abs_err, kernel_ms, plain_ms)}
    (times only when `timed`)."""
    from wvpk_torch.engine.staging import bucket_tensors
    from wvpk_torch.ops.decorr import decorr_post
    from wvpk_torch.ops.decorr_cuda import decorr_post_cuda
    from wvpk_torch.ops.entropy import entropy_decode
    from wvpk_torch.ops.entropy_cuda import entropy_decode_cuda

    t = bucket_tensors(bucket, device)
    prof = bucket.profile
    ent_args = (t["words"], t["nwords_lane"], t["med"])
    ent_kw = dict(mono=prof.mono, nsteps=prof.nsteps)
    k_res = entropy_decode_cuda(*ent_args, **ent_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_res = entropy_decode(*ent_args, **ent_kw)
    torch.cuda.synchronize()
    ent_plain_ms = 1000 * (time.perf_counter() - t0)
    for name, w, g in zip(("residuals", "broke", "ndec"), p_res, k_res):
        if not torch.equal(w, g):
            raise AssertionError(f"entropy kernel != plain version: {name}")
    ent_err = _max_abs_err(p_res[0], k_res[0])

    residuals, broke = k_res[0], k_res[1]
    dec_args = (residuals, t["terms"], t["deltas16"], t["wa"], t["wb"],
                t["hist_a"], t["hist_b"], t["num_terms"], t["nsamples"],
                t["joint"], t["mute_limit"])
    k_dec = decorr_post_cuda(*dec_args, mono=prof.mono)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_dec = decorr_post(*dec_args, mono=prof.mono)
    torch.cuda.synchronize()
    dec_plain_ms = 1000 * (time.perf_counter() - t0)
    for name, w, g in zip(("out", "crc", "first_bad"), p_dec, k_dec):
        if not torch.equal(w, g):
            raise AssertionError(f"decorr kernel != plain version: {name}")
    dec_err = max(_max_abs_err(w, g) for w, g in zip(p_dec, k_dec))
    if broke.any():
        raise AssertionError("corpus lanes hit an EOF break")

    ent_ms = dec_ms = None
    if timed:
        ent_ms = _events_ms(lambda: entropy_decode_cuda(*ent_args, **ent_kw),
                            5)
        dec_ms = _events_ms(lambda: decorr_post_cuda(*dec_args,
                                                     mono=prof.mono), 5)
    return {"entropy": (ent_err, ent_ms, ent_plain_ms),
            "decorr": (dec_err, dec_ms, dec_plain_ms)}


def check_results(results, states, per_file, pcms):
    """0 CRC errors, 0 mutes, every file sample-exact against its source
    PCM, and the scalar oracle agreeing on a few blocks."""
    from wvpk.ref import decode_block

    crc_errors = sum(r.crc_error for r in results)
    mutes = sum(r.mute_error for r in results)
    if crc_errors or mutes:
        raise AssertionError(f"{crc_errors} CRC errors, {mutes} mutes")
    pos = 0
    for k, nblk in enumerate(per_file):
        got = np.concatenate([r.samples for r in results[pos:pos + nblk]])
        if not np.array_equal(got, pcms[k % len(pcms)]):
            raise AssertionError(f"file {k} is not sample-exact")
        pos += nblk
    probe = sorted({0, per_file[0] - 1, len(states) // 2, len(states) - 1})
    for i in probe:
        if not np.array_equal(decode_block(states[i]).samples,
                              results[i].samples):
            raise AssertionError(f"oracle disagrees on block {i}")
    return crc_errors, mutes, len(probe)


def stage_breakdown(states, device):
    """One decode split into its stages, each closed by a synchronize:
    seconds per stage."""
    from wvpk_torch.engine import pipeline
    from wvpk_torch.engine.fused import deliver, fused_decode
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
        out, crc, mute = fused_decode(
            **t, mono=b.profile.mono, int32_expand=b.profile.is_int32,
            nsteps=b.profile.nsteps)
        mark("decode_kernels")
        bps = pipeline._bucket_bps(b)
        payload, crcmute = deliver(out, crc, mute, bps)
        mark("pack")
        launched.append(pipeline.LaunchedBucket(b, payload, crcmute, bps))
    fetched = pipeline._fetch_arrays(
        [a for lb in launched for a in (lb.crcmute, lb.payload)])
    mark("d2h")
    for k, lb in enumerate(launched):
        pipeline.finalize_bucket(lb, fetched[2 * k], fetched[2 * k + 1])
    mark("finalize")
    return marks


def run_cli(wv_bytes, pcm, device):
    """The CLI on one file: its .wav must be the WAV header plus the
    source PCM, byte for byte."""
    from wvpk.io.wav import make_wav_header

    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "f0.wv")
    dst = os.path.join(work, "f0.wav")
    with open(src, "wb") as f:
        f.write(wv_bytes)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "wvpk_torch.cli", src, "-o", dst, "-q",
         "--device", str(device)],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"CLI exited {proc.returncode}: {proc.stderr}")
    want = make_wav_header(len(pcm), 2, 44100, 16, 2) \
        + pcm.astype("<i2").tobytes()
    with open(dst, "rb") as f:
        if f.read() != want:
            raise AssertionError("CLI .wav differs from header + source PCM")
    return secs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from wvpk_torch import _build
    from wvpk_torch.engine import decode_states
    from wvpk_torch.engine.staging import group_blocks
    from wvpk_torch.ops.decorr_cuda import decorr_post_cuda
    from wvpk_torch.ops.entropy_cuda import entropy_decode_cuda

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])

    t0 = time.perf_counter()
    for name in ("entropy", "decorr"):
        _build.load(name)
    build_s = time.perf_counter() - t0
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "stack frame" in ln]
             for k, v in _build.ptxas_log.items()}
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "nvcc_seconds": _build.build_seconds,
                      "ptxas": ptxas}))

    t0 = time.perf_counter()
    files, pcms = make_corpus()
    states, per_file = parse_corpus(files, N_FILES)
    frames = sum(len(pcms[k % N_DISTINCT]) for k in range(N_FILES))
    print(json.dumps({"phase": "corpus", "files": N_FILES,
                      "distinct": N_DISTINCT, "blocks": len(states),
                      "frames": frames,
                      "wv_bytes": sum(len(files[k % N_DISTINCT])
                                      for k in range(N_FILES)),
                      "seconds": time.perf_counter() - t0}))

    slice64 = compare_kernels(group_blocks(states[:64])[0], dev, False)
    print(json.dumps({"phase": "kernels_vs_plain_64_lanes",
                      "max_abs_err": {k: v[0] for k, v in slice64.items()}}))

    # the main path's shapes: the corpus's largest bucket (every file's
    # last, short block stages into a second, smaller one)
    buckets = group_blocks(states)
    b = max(buckets, key=lambda x: len(x.states))
    full = compare_kernels(b, dev, True)
    print(json.dumps({"phase": "kernels_vs_plain_full_bucket",
                      "buckets": [len(x.states) for x in buckets],
                      "lanes": len(b.states), "T": b.profile.nsamples_cap,
                      "words_per_lane": int(b.words.shape[1]),
                      "results": {k: {"max_abs_err": v[0], "ms": v[1],
                                      "plain_ms": v[2]}
                                  for k, v in full.items()}}))
    del b, buckets

    entropy_decode_cuda.launches = 0
    decorr_post_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for rep in range(4):
        # a caller consumes each call's output before the next: holding
        # the previous ~270 MB of results while the next call allocates
        # its own slowed finalize 2-4x on the card's host
        results = None
        t0 = time.perf_counter()
        results = decode_states(states, dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rep > 0:
            rates.append(frames / dt / 1e6)
    launches = {"entropy": entropy_decode_cuda.launches,
                "decorr": decorr_post_cuda.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    crc_errors, mutes, probed = check_results(results, states, per_file,
                                              pcms)
    results = None
    print(json.dumps({"phase": "decode_states", "warmup": 1,
                      "msamples_per_s": rates, "frames": frames,
                      "crc_errors": crc_errors, "mutes": mutes,
                      "oracle_blocks": probed, "launches": launches,
                      "peak_device_bytes": torch.cuda.max_memory_allocated()}))
    print(json.dumps({"phase": "stage_seconds",
                      "stages": stage_breakdown(states, dev)}))

    cli_s = run_cli(files[0], pcms[0], dev)
    print(json.dumps({"phase": "cli", "byte_exact": True,
                      "seconds": cli_s}))

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")

    replaces = {"entropy": "wvpk/ops/entropy_pallas.py:115",
                "decorr": "wvpk/ops/decorr_pallas.py:163"}
    names = {"entropy": "entropy_decode", "decorr": "decorr_post"}
    print(json.dumps({"kernels": [
        {"name": names[k], "route": "cuda",
         "source": f"wvpk_torch/csrc/{k}.cu", "replaces": replaces[k],
         "launches": launches[k], "max_abs_err": full[k][0],
         "ms": full[k][1], "plain_ms": full[k][2]} for k in full]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
