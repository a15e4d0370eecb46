#!/usr/bin/env python3
"""Same-card comparisons of wvpk_torch on one NVIDIA GPU.

    python3 wvpk_torch/tools/kernel_ab.py OLD_ROOT NEW_ROOT [--reps 5]
        [--calls 5]
    python3 wvpk_torch/tools/kernel_ab.py --runs ROOT [--reps 5]
    python3 wvpk_torch/tools/kernel_ab.py --dsd OLD_ROOT NEW_ROOT
    python3 wvpk_torch/tools/kernel_ab.py --dsd ROOT
    python3 wvpk_torch/tools/kernel_ab.py --encode OLD_ROOT NEW_ROOT
    python3 wvpk_torch/tools/kernel_ab.py --wvx OLD_ROOT NEW_ROOT
    python3 wvpk_torch/tools/kernel_ab.py --sass OLD_ROOT NEW_ROOT
    python3 wvpk_torch/tools/kernel_ab.py --e2e OLD_ROOT NEW_ROOT
    python3 wvpk_torch/tools/kernel_ab.py --store OLD_ROOT NEW_ROOT
    python3 wvpk_torch/tools/kernel_ab.py --very-high OLD_ROOT NEW_ROOT

Two checkouts, in turns old, new, new, old. Each turn is a process of its
own with that root's `wvpk_torch` and `chip_smoke.py` first on the path
(the packages share a name), so each side builds its own kernels (into
ROOT/build/) and its own corpus with its own code. A turn takes the
lossless bench corpus (chip_smoke.make_corpus: 192 files, 8,448 blocks)
and measures:
  - the entropy and decorrelation kernels at its largest bucket (8,256
    lanes): `--reps` back-to-back launches timed with CUDA events, and a
    digest of each kernel's outputs, which must agree across the turns
    (the decorrelation kernel gets the bucket's `static_terms` where the
    root's wrapper takes it);
  - group_blocks alone, `--calls` times before any CUDA work (ms);
  - decode_states end to end: one warm-up and `--calls` timed calls (host
    clock, closed by a synchronize; Msamples/s), each call's output
    released before the next; then `--calls` runs of the root's
    chip_smoke.stage_breakdown (ms per stage).
Prints one JSON line per turn, then a summary line.

`--runs` times how a mixed-chain bucket's lane runs share the card, on
ROOT's decorrelation kernels, at three buckets of chip_smoke.py's corpora:
the hybrid corpus' largest (5,698 lanes, two chains), the wvc corpus'
(8,096 lanes, two chains, the wvc arm) and the mixed-chain corpus' (430
lanes, five runs). Each is timed two ways, in turns wrapper, sequence,
sequence, wrapper: the wrapper's call (each run's kernel launched on a
stream of its own, forked from the current stream and joined back into
it) and one call a run, in sequence on the current stream. Both must
give the same outputs.

`--dsd OLD_ROOT NEW_ROOT` runs the same turns on the DSD corpus of
chip_smoke.submit_dsd (three groups of 696 stereo lanes: mode 1 with 4
and 32 history bins, mode 3; mono mode 1 and 3 files; a mode-0 file):
  - each group kernel at the full group, on 64 lanes of the first signal
    and on 64 lanes of the first random signal (`--reps` launches each,
    CUDA events), with a digest of each launch's outputs, which must
    agree across the turns;
  - decode_states end to end: one warm-up and `--calls` timed calls
    (Mbytevals/s), then `--calls` runs of the root's
    chip_smoke.dsd_stage_breakdown.
`--dsd ROOT` times ROOT's call with its groups on side streams against
the groups one after another (chip_smoke.dsd_side_vs_sequence, `--calls`
times, each in turns side, sequence, sequence, side), then its launch
order (mode 3 first) against the groups' own order on side streams; all
must give the same outputs.

`--encode OLD_ROOT NEW_ROOT` runs the same turns on the encode track of
chip_smoke.py (chip_smoke.track_head: a 768 s stereo track, 8,269 lanes of
4,096 samples, the default preset, warm seeding over 512 samples):
  - the encode kernels at the encoder's launches with the root's
    main-path arguments (`static_terms` where its wrapper takes it): the
    warm invert (512 steps, final state) and the main invert, the word
    coder, and the hybrid kernel at bitrate 512, at all lanes and on the
    first 64 (`--reps` launches each, CUDA events), with a digest of
    each launch's outputs, which must agree across the turns; the invert
    also on 64 lanes of the mono small file and of the track at the high
    preset, and, where the root's invert takes `static_terms`, its
    run-time kernel on all lanes of the main launch;
  - the decode kernels that share the coders' headers, at chip_smoke.py's
    launches: the entropy kernel's hybrid profile (the hybrid corpus'
    largest bucket) and `wvc=True` profile (the wvc corpus'), the
    correction scan on that profile's outputs (the wvc turn), the
    decorrelation chain kernel (the lossless corpus' largest bucket, its
    chain as `static_terms`) and its wvc arm (the wvc bucket, its chain
    runs), each with a digest; then `--calls` runs of the root's
    chip_smoke.stage_breakdown on the wvc corpus;
  - encode_device on the track, lossless and hybrid: one warm-up and
    `--calls` timed calls each (host clock, closed by a synchronize;
    Msamples/s), every call's enc_* stage split, a digest of the bytes.
`--calls 0` times the encode kernels alone. A row that one root has and
the other lacks is timed where it exists; digests are compared on the
rows both have.

`--wvx OLD_ROOT NEW_ROOT` runs the same turns on the int32+wvx corpus of
chip_smoke.py (chip_smoke.make_wvx: 4 files x WVX_COPIES, one bucket of
1,584 stereo lanes of 4,096 samples):
  - the wvx injection kernel at the bucket and on its first 64 lanes, on
    the pipeline's inputs (the entropy and decorrelation kernels'
    outputs, muted lanes masked): `--reps` launches each, CUDA events,
    with a digest of each launch's outputs, which must agree across the
    turns, and ptxas' line for csrc/wvx.cu where the turn built it;
  - decode_states end to end: one warm-up and `--calls` timed calls
    (Msamples/s), then `--calls` runs of the root's
    chip_smoke.stage_breakdown.

`--sass OLD_ROOT NEW_ROOT` builds both roots' sources that share headers
(SASS_SOURCES) and compares their kernels' SASS (`cuobjdump -sass`, the
addresses and encodings dropped), kernel by kernel, matched by name and
template arguments: one JSON line of the kernels identical, differing and
found in one root only, per source.

`--e2e OLD_ROOT NEW_ROOT` runs the same turns on decode_states end to
end, at the default options, on three calls: the lossless corpus (192
files), the DSD corpus of `--dsd`, and chip_smoke.py's mixed call (the
first 16 lossless files with the DSD corpus). Each gets one warm-up and
`--calls` timed calls (host clock, closed by a synchronize), every call's
pipeline stages as `trace.collect` gives them (staging, launch, transfer,
finalize: host clock, unsynchronised), and a digest of the samples,
which must agree across the turns.

`--store OLD_ROOT NEW_ROOT` runs the same turns on one bucket at the
library cell's shape (PERF.md section 4: 3,850 stereo lanes of 22,050
samples, capacity 32,768 steps, the default chain, lossless 16-bit;
STORE_BLOCKS encoded blocks repeated): the root's `deliver_bucket` (the
entropy kernel, the decorrelation kernel and whatever the root runs to
make the delivered payload) and its entropy kernel alone, `--reps`
launches each with CUDA events, their difference the store's time; the
peak device memory of one deliver_bucket over what was allocated before
it; one deliver_bucket under torch.profiler, its device time by kernel
and its ops grouped by input shape; a digest of the payload and CRC/mute
table, which must agree across the turns.

`--very-high OLD_ROOT NEW_ROOT` runs the same turns on the decorrelation
kernel of the very high chains (16 terms stereo, 14 mono; PERF.md
section 4), on seeded inputs made on the card (random residuals,
weights and histories, most lanes at their bucket's sample count, a few
empty or short, a tenth muted by their limit): at the very high
library cell's bucket (VH_BUCKET: 1,925 lanes staged at 65,536 steps,
44,100 samples), at chip_smoke.py's very high corpus shape (VH_CORPUS)
and at the card tests' (VH_SMALL), stereo and mono, each store
(`packed` at 2 bytes a sample, `unpacked`, the `wvc` arm): `--reps`
launches each with CUDA events, and a digest of each launch's outputs,
which must agree across the turns.

Needs one CUDA device; imports no jax.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import time

# the sources whose kernels --sass compares: those sharing a header that a
# change may touch (stream.cuh, stage.cuh, decorr_pass.cuh)
SASS_SOURCES = ("entropy", "decorr", "wvx", "encode_words", "encode_hybrid")


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _timed(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (ms)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _import_root(root: str):
    """`root`'s chip_smoke module, with its wvpk_torch first on the path."""
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke

    return chip_smoke


def measure(root: str, reps: int, calls: int) -> dict:
    """One turn: `root`'s main-path kernels and decode_states on the
    lossless corpus."""
    cs = _import_root(root)
    import torch

    from wvpk_torch.engine import decode_states
    from wvpk_torch.engine.staging import bucket_tensors, group_blocks
    from wvpk_torch.ops.decorr_cuda import decorr_post_cuda
    from wvpk_torch.ops.entropy_cuda import entropy_decode_cuda

    dev = torch.device("cuda")
    files, pcms = cs.make_corpus()
    states, _ = cs.parse_corpus(files, cs.N_FILES)
    frames = cs._frames(pcms, cs.N_FILES)
    staging = []            # group_blocks alone, before any CUDA work
    for _ in range(calls):
        t0 = time.perf_counter()
        group_blocks(states)
        staging.append(1000 * (time.perf_counter() - t0))
    b = max(group_blocks(states), key=lambda x: len(x.states))
    t = bucket_tensors(b, dev)
    prof = b.profile
    eargs = (t["words"], t["nwords_lane"], t["med"], t["slow"], t["acc"],
             t["delta"])
    ekw = dict(mono=prof.mono, nsteps=prof.nsteps, hybrid=False)
    res = entropy_decode_cuda(*eargs, **ekw)
    dargs = (res[0], t["terms"], t["deltas16"], t["wa"], t["wb"],
             t["hist_a"], t["hist_b"], t["num_terms"], t["nsamples"],
             t["joint"], t["mute_limit"])
    dkw = dict(mono=prof.mono)
    if "static_terms" in inspect.signature(decorr_post_cuda).parameters:
        terms = b.terms[0, :int(b.num_terms[0])]
        dkw["static_terms"] = tuple(int(x) for x in terms)
    dec = decorr_post_cuda(*dargs, **dkw)
    kernels = (lambda: entropy_decode_cuda(*eargs, **ekw),
               lambda: decorr_post_cuda(*dargs, **dkw))
    for fn in kernels:      # a round untimed: the card's clocks come up
        _timed(fn, reps)
    turn = {"root": root, "lanes": len(b.states),
            "steps": prof.nsamples_cap,
            "entropy_ms": _timed(kernels[0], reps),
            "decorr_ms": _timed(kernels[1], reps),
            "decorr_kwargs": sorted(dkw), "entropy_digest": _digest(res),
            "decorr_digest": _digest(dec)}
    del t, res, dec, dargs, eargs, kernels

    rates, results = [], None
    for rep in range(calls + 1):
        results = None
        t0 = time.perf_counter()
        results = decode_states(states, dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rep:
            rates.append(frames / dt / 1e6)
    bad = sum(r.crc_error or r.mute_error for r in results)
    h = hashlib.sha256()
    for r in results:
        h.update(r.samples.tobytes())
    results = None
    stages = [{k: 1000 * v for k, v in cs.stage_breakdown(states, dev).items()}
              for _ in range(calls)]
    turn.update(staging_ms=staging, msamples_per_s=rates, bad_blocks=bad,
                decode_digest=h.hexdigest()[:16], stage_ms=stages)
    return turn


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def ab(old: str, new: str, reps: int, calls: int) -> int:
    turns = []
    for root in (old, new, new, old):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, "--turn",
             "--reps", str(reps), "--calls", str(calls)],
            capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(turn))
        turns.append(turn)
    same = all(t[k] == turns[0][k] for t in turns
               for k in ("entropy_digest", "decorr_digest", "decode_digest"))
    sides = {"old": turns[0::3], "new": turns[1:3]}
    stage_names = list(turns[0]["stage_ms"][0])
    print(json.dumps({
        "same_outputs": same,
        "bad_blocks": sum(t["bad_blocks"] for t in turns),
        **{key: {side: [t[key] for t in ts] for side, ts in sides.items()}
           for key in ("entropy_ms", "decorr_ms")},
        **{key: {side: [r for t in ts for r in t[key]]
                 for side, ts in sides.items()}
           for key in ("staging_ms", "msamples_per_s")},
        "stage_ms_median": {
            side: {s: _median([m[s] for t in ts for m in t["stage_ms"]])
                   for s in stage_names}
            for side, ts in sides.items()}}))
    return 0 if same and not any(t["bad_blocks"] for t in turns) else 1


STORE_BLOCKS = 64       # distinct blocks of the --store bucket
STORE_LANES = 3850      # its lanes: a library call's blocks


def _library_bucket():
    """The --store bucket: STORE_BLOCKS 22,050-sample blocks of a tone over
    noise, 16-bit stereo, joint, the default chain, repeated to
    STORE_LANES lanes."""
    import numpy as np

    from wvpk_torch.container import parse_blocks
    from wvpk_torch.engine.staging import group_blocks
    from wvpk_torch.testgen import EncodeSpec, encode_file

    n = 22050 * STORE_BLOCKS
    rng = np.random.default_rng(15)
    sig = 6000 * np.sin(2 * np.pi * 440 * np.arange(n) / 44100) \
        + rng.normal(0, 800, n)
    pcm = np.stack([sig, 0.6 * sig + rng.normal(0, 300, n)], 1)
    data = encode_file(np.round(pcm).astype(np.int64), EncodeSpec(
        block_samples=22050, joint=True, terms=(18, 18, 2, 17, 3),
        deltas=(2,) * 5))
    states = [b.state for b in parse_blocks(data)]
    (b,) = group_blocks((states * (STORE_LANES // len(states) + 1))
                        [:STORE_LANES])
    return b


def _device_ms(evt, total=False) -> float:
    """An averaged profiler event's device time (its own, or with
    `total` its children's too), in ms, under either of torch's names."""
    name = "device_time_total" if total else "self_device_time_total"
    us = getattr(evt, name, None)
    if us is None:
        us = getattr(evt, name.replace("device", "cuda"))
    return us / 1e3


def measure_store(root: str, reps: int) -> dict:
    """One --store turn on `root`."""
    _import_root(root)
    import torch

    from wvpk_torch.engine import pipeline
    from wvpk_torch.engine.staging import bucket_tensors
    from wvpk_torch.ops.entropy_cuda import entropy_decode_cuda

    dev = torch.device("cuda")
    b = _library_bucket()
    t = bucket_tensors(b, dev)
    prof = b.profile

    def deliver():
        return pipeline.deliver_bucket(b, t)

    def entropy():
        return entropy_decode_cuda(
            t["words"], t["nwords_lane"], t["med"], t["slow"], t["acc"],
            t["delta"], mono=prof.mono, nsteps=prof.nsteps, hybrid=False)

    digest = _digest(deliver())
    for fn in (deliver, entropy):     # a round untimed: clocks come up
        _timed(fn, reps)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    deliver()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    deliver_ms, entropy_ms = _timed(deliver, reps), _timed(entropy, reps)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as p:
        deliver()
        torch.cuda.synchronize()
    kernels = sorted(((e.key, _device_ms(e)) for e in p.key_averages()
                      if _device_ms(e) > 0), key=lambda r: -r[1])
    ops = sorted(((e.key, str(e.input_shapes), _device_ms(e, total=True))
                  for e in p.key_averages(group_by_input_shape=True)
                  if e.key.startswith("aten::")), key=lambda r: -r[2])
    return {"root": root, "lanes": len(b.states),
            "steps": prof.nsamples_cap, "deliver_ms": deliver_ms,
            "entropy_ms": entropy_ms, "store_ms": deliver_ms - entropy_ms,
            "peak_mb": peak / 2**20, "kernel_ms": kernels[:12],
            "kernel_ms_sum": sum(ms for _k, ms in kernels),
            "ops_by_shape_ms": [r for r in ops[:12] if r[2] > 0],
            "digest": digest, "card": torch.cuda.get_device_name(0)}


def ab_store(old: str, new: str, reps: int) -> int:
    turns = []
    for root in (old, new, new, old):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root,
             "--store-turn", "--reps", str(reps)],
            capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(turn))
        turns.append(turn)
    same = all(t["digest"] == turns[0]["digest"] for t in turns)
    sides = {"old": turns[0::3], "new": turns[1:3]}
    print(json.dumps({
        "same_outputs": same,
        **{key: {side: [t[key] for t in ts] for side, ts in sides.items()}
           for key in ("deliver_ms", "entropy_ms", "store_ms", "peak_mb",
                       "kernel_ms_sum")}}))
    return 0 if same else 1


# (lanes, staged steps, samples a lane) of the --very-high shapes
VH_BUCKET = (1925, 65536, 44100)
VH_CORPUS = (2016, 4096, 4096)
VH_SMALL = (45, 200, 200)


def _very_high_inputs(mono, L, T, ns, wvc, dev):
    """Seeded decorrelation inputs of L lanes on the very high chain of
    `mono`'s channel count, made on `dev` (the same on one card and torch
    build): (arguments, keywords of the packed store, its terms)."""
    import torch

    from wvpk_torch.ops.decorr import Pack
    from wvpk_torch.ops.decorr_cuda import CHAINS

    name = "very_high_mono" if mono else "very_high"
    (chain,) = [t for n, _m, t in CHAINS if n == name]
    g = torch.Generator(device=dev).manual_seed(18 + int(mono))
    C = 1 if mono else 2
    i32 = torch.int32

    def rand(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=i32)

    terms = torch.zeros(L, 16, dtype=i32, device=dev)
    terms[:, :len(chain)] = torch.tensor(chain, dtype=i32, device=dev)
    deltas = (terms != 0).to(i32) * 2
    nsamples = torch.full((L,), ns, dtype=i32, device=dev)
    nsamples[:3] = torch.tensor((0, 1, ns - 1), dtype=i32, device=dev)
    lim = torch.where(rand(0, 10, L) == 0, 2**13, 2**40).to(torch.int64)
    args = [rand(-2**14, 2**14, T, L, C), terms, deltas,
            rand(-1024, 1024, L, 16), rand(-1024, 1024, L, 16),
            rand(-2**15, 2**15, L, 16, 8), rand(-2**15, 2**15, L, 16, 8),
            torch.full((L,), len(chain), dtype=i32, device=dev), nsamples,
            rand(0, 2, L), lim]
    if wvc:
        args.insert(1, rand(-2**12, 2**12, T, L, C))
    pack = Pack(rand(0, 100, L) == 0, torch.zeros(L, dtype=i32, device=dev),
                2, False)
    return args, pack, chain


def measure_very_high(root: str, reps: int) -> dict:
    """One --very-high turn on `root`."""
    _import_root(root)
    import torch

    from wvpk_torch.ops.decorr_cuda import decorr_post_cuda, \
        decorr_post_wvc_cuda

    dev = torch.device("cuda")
    ms, digests = {}, {}
    for shape, (L, T, ns) in (("bucket", VH_BUCKET), ("corpus", VH_CORPUS),
                              ("small", VH_SMALL)):
        for mono in (False, True):
            for store in ("packed", "unpacked", "wvc"):
                args, pack, chain = _very_high_inputs(
                    mono, L, T, ns, store == "wvc", dev)
                kw = dict(mono=mono, static_terms=chain)
                fn = decorr_post_wvc_cuda if store == "wvc" \
                    else decorr_post_cuda
                if store == "packed":
                    kw["pack"] = pack
                key = f"{shape}.{'mono' if mono else 'stereo'}.{store}"
                digests[key] = _digest(fn(*args, **kw))
                _timed(lambda: fn(*args, **kw), reps)   # clocks come up
                ms[key] = _timed(lambda: fn(*args, **kw), reps)
                del args, pack
                torch.cuda.empty_cache()
    return {"root": root, "ms": ms, "digest": digests,
            "card": torch.cuda.get_device_name(0)}


def ab_very_high(old: str, new: str, reps: int) -> int:
    turns = []
    for root in (old, new, new, old):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root,
             "--very-high-turn", "--reps", str(reps)],
            capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(turn))
        turns.append(turn)
    same = all(t["digest"] == turns[0]["digest"] for t in turns)
    sides = {"old": turns[0::3], "new": turns[1:3]}
    print(json.dumps({
        "same_outputs": same,
        "ms": {key: {side: [t["ms"][key] for t in ts]
                     for side, ts in sides.items()}
               for key in turns[0]["ms"]}}))
    return 0 if same else 1


def _mixed_buckets(cs):
    """(name, bucket, decorrelation kernel, its CUDA inputs) of the three
    buckets `--runs` times; the residuals (and the wvc arm's corrections)
    come from the root's entropy and correction kernels."""
    import torch

    from wvpk_torch.engine.staging import bucket_tensors, group_blocks
    from wvpk_torch.ops.decorr_cuda import decorr_post_cuda, \
        decorr_post_wvc_cuda
    from wvpk_torch.ops.entropy_cuda import entropy_decode_cuda, \
        entropy_decode_wvc_cuda
    from wvpk_torch.ops.wvc_cuda import wvc_corrections_cuda

    dev = torch.device("cuda")
    files, _ = cs.make_hybrid()
    hybrid = cs.parse_corpus(files, len(files) * cs.HYBRID_COPIES)[0]
    pairs, _ = cs.make_wvc()
    wvc = cs.parse_corpus(pairs, len(pairs) * cs.WVC_COPIES)[0]
    mixed = [cs.make_mixed(k)[0]
             for k in range(cs.MIX_FILES * len(cs.MIX_CHAINS))]
    mixed = cs.parse_corpus(mixed, len(mixed))[0]
    for name, states in (("hybrid", hybrid), ("wvc", wvc),
                         ("mixed_chains", mixed)):
        b = max(group_blocks(states), key=lambda x: len(x.states))
        t = bucket_tensors(b, dev)
        args, kw = cs._entropy_io(t, b.profile)
        if b.profile.has_wvc:
            res, mc, base, _broke, _ = entropy_decode_wvc_cuda(*args, **kw)
            corr = wvc_corrections_cuda(t["wvc_words"], mc, base, res)
            fn, lead = decorr_post_wvc_cuda, (res, corr)
        else:
            res = entropy_decode_cuda(*args, hybrid=b.profile.hybrid,
                                      **kw)[0]
            fn, lead = decorr_post_cuda, (res,)
        rest = cs._decorr_args(t, res)[1:]
        # int32 once (the wrapper converts them on every launch); the mute
        # limits stay int64, which the wrapper clamps
        rest = tuple(x.to(torch.int32).contiguous() for x in rest[:-1]) \
            + rest[-1:]
        yield name, b, fn, lead + rest


def runs(root: str, reps: int) -> int:
    """`--runs`: the wrapper's side streams against the runs in sequence,
    at the three mixed buckets."""
    cs = _import_root(root)
    import torch

    from wvpk_torch.ops import decorr_cuda

    report, same = {}, True
    for name, b, fn, args in _mixed_buckets(cs):
        mono = b.profile.mono
        wvc = fn is decorr_cuda.decorr_post_wvc_cuda
        inputs = (args[0], args[1] if wvc else None) + args[1 + wvc:]
        lanes = decorr_cuda.lane_runs(len(b.states), mono, b.static_terms,
                                      b.chain_segments)

        def launch(rs, inputs=inputs, mono=mono):
            return decorr_cuda._launch(*inputs, mono=mono, runs=rs)

        def wrapper(lanes=lanes, launch=launch):
            return [(lanes, launch(lanes))]

        def sequence(lanes=lanes, launch=launch):
            return [([r], launch([r])) for r in lanes]

        def lanes_of(parts):
            """Each output with every lane taken from the call that ran
            its run."""
            full = [torch.zeros_like(x) for x in parts[0][1] if x is not None]
            for rs, outs in parts:
                for _cid, s, e in rs:
                    for f, x in zip(full, [x for x in outs if x is not None]):
                        if f.ndim == 3:
                            f[:, s:e] = x[:, s:e]
                        else:
                            f[s:e] = x[s:e]
            return full

        same &= all(torch.equal(w, g) for w, g in
                    zip(lanes_of(wrapper()), lanes_of(sequence())))
        ms = {"wrapper": [], "sequence": []}
        for way in (wrapper, sequence, sequence, wrapper):
            ms[way.__name__].append(_timed(way, reps))
        report[name] = {"lanes": len(b.states), "wvc": wvc,
                        "runs": [list(r) for r in lanes], "ms": ms}
    print(json.dumps({"runs": report, "same_outputs": same}))
    return 0 if same else 1


def _dsd_corpus(cs):
    """The root's DSD corpus: (states, byte-values, {group name: states}),
    its files encoded in a pool as chip_smoke.py encodes them."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from wvpk_torch.container import parse_blocks

    with ProcessPoolExecutor(
            max_workers=cs.POOL_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = cs.submit_dsd(pool)
        files = {name: [f.result() for f in futs]
                 for name, futs in jobs.items()}
    groups = {name: [b.state for wv, _src in fs for b in parse_blocks(wv)]
              for name, fs in files.items()}
    vals = sum(src.size for fs in files.values() for _wv, src in fs)
    return [st for sts in groups.values() for st in sts], vals, groups


def measure_dsd(root: str, reps: int, calls: int) -> dict:
    """One `--dsd` turn: `root`'s DSD kernels and decode_states on its
    DSD corpus."""
    cs = _import_root(root)
    import torch

    from wvpk_torch.engine import decode_states
    from wvpk_torch.engine.dsd_pipeline import group_dsd

    dev = torch.device("cuda")
    states, vals, groups = _dsd_corpus(cs)
    kernels = {}
    for name, sts in groups.items():
        if name == "dsd_raw":
            continue
        g = max(group_dsd(sts), key=lambda x: len(x.sts))
        slices = {"full": g}
        per_file = len(g.sts) // cs.DSD_SIGNALS
        if len(g.sts) >= cs.DSD_SIGNALS * 64:
            lo = per_file * (cs.DSD_SIGNALS - cs.DSD_RANDOM)
            slices["first64"] = group_dsd(g.sts[:64])[0]
            slices["random64"] = group_dsd(g.sts[lo:lo + 64])[0]
        row = {"lanes": len(g.sts)}
        for key, gs in slices.items():
            (kernel, _plain), args, kw = cs._dsd_inputs(gs, dev)
            out = kernel(*args, **kw)
            _timed(lambda: kernel(*args, **kw), reps)   # clocks up
            row[f"{key}_ms"] = _timed(lambda: kernel(*args, **kw), reps)
            row[f"{key}_digest"] = _digest(out)
            if key == "full" and hasattr(cs, "_launcher"):
                # the kernel alone, without the wrapper's checks
                row["alone_ms"] = _timed(cs._launcher(kernel, args, kw),
                                          reps)
        kernels[name] = row
    rates, results = [], None
    for rep in range(calls + 1):
        results = None
        t0 = time.perf_counter()
        results = decode_states(states, dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rep:
            rates.append(vals / dt / 1e6)
    bad = sum(r.crc_error or r.mute_error for r in results)
    h = hashlib.sha256()
    for r in results:
        h.update(r.samples.tobytes())
    results = None
    stages = [{k: 1000 * v
               for k, v in cs.dsd_stage_breakdown(states, dev).items()}
              for _ in range(calls)]
    return {"root": root, "kernels": kernels, "mbytevals_per_s": rates,
            "bad_blocks": bad, "decode_digest": h.hexdigest()[:16],
            "stage_ms": stages,
            "card": torch.cuda.get_device_name(0)}


def ab_dsd(old: str, new: str, reps: int, calls: int) -> int:
    turns = []
    for root in (old, new, new, old):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, "--dsd-turn",
             "--reps", str(reps), "--calls", str(calls)],
            capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(turn))
        turns.append(turn)
    digests = [{(name, k): v for name, row in t["kernels"].items()
                for k, v in row.items() if k.endswith("digest")}
               | {"decode": t["decode_digest"]} for t in turns]
    same = all(d == digests[0] for d in digests)
    sides = {"old": turns[0::3], "new": turns[1:3]}
    stage_names = list(turns[0]["stage_ms"][0])
    print(json.dumps({
        "same_outputs": same,
        "bad_blocks": sum(t["bad_blocks"] for t in turns),
        "kernel_ms": {
            name: {key: {side: [t["kernels"][name].get(key) for t in ts]
                         for side, ts in sides.items()}
                   for key in sorted({k for t in turns
                                      for k in t["kernels"][name]})
                   if key.endswith("_ms")}
            for name in turns[0]["kernels"]},
        "mbytevals_per_s": {side: [r for t in ts
                                   for r in t["mbytevals_per_s"]]
                            for side, ts in sides.items()},
        "stage_ms_median": {
            side: {s: _median([m[s] for t in ts for m in t["stage_ms"]])
                   for s in stage_names}
            for side, ts in sides.items()}}))
    return 0 if same and not any(t["bad_blocks"] for t in turns) else 1


def measure_e2e(root: str, calls: int) -> dict:
    """One `--e2e` turn: `root`'s decode_states on the lossless, DSD and
    mixed calls."""
    cs = _import_root(root)
    import torch

    from wvpk_torch import trace
    from wvpk_torch.engine import decode_states

    dev = torch.device("cuda")
    files, pcms = cs.make_corpus()
    lossless, _ = cs.parse_corpus(files, cs.N_FILES)
    head, _ = cs.parse_corpus(files, 16)
    dsd, vals, _groups = _dsd_corpus(cs)
    units = {"lossless": ("msamples_per_s", cs._frames(pcms, cs.N_FILES)),
             "dsd": ("mbytevals_per_s", vals)}
    turn = {"root": root, "card": torch.cuda.get_device_name(0)}
    for name, states in (("lossless", lossless), ("dsd", dsd),
                         ("mixed", head + dsd)):
        secs, stages, results = [], [], None
        for rep in range(calls + 1):
            results = None
            with trace.collect() as sink:
                t0 = time.perf_counter()
                results = decode_states(states, dev)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            if rep:
                secs.append(dt)
                stages.append({k: 1000 * v
                               for k, v in sink.seconds().items()})
        h = hashlib.sha256()
        for r in results:
            h.update(r.samples.tobytes())
        row = {"blocks": len(states), "call_s": secs, "stage_ms": stages,
               "bad_blocks": sum(r.crc_error or r.mute_error
                                 for r in results),
               "digest": h.hexdigest()[:16]}
        if name in units:
            key, n = units[name]
            row[key] = [n / x / 1e6 for x in secs]
        turn[name] = row
        results = None
    return turn


def ab_e2e(old: str, new: str, calls: int) -> int:
    turns = []
    for root in (old, new, new, old):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, "--e2e-turn",
             "--calls", str(calls)],
            capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(turn))
        turns.append(turn)
    names = ("lossless", "dsd", "mixed")
    same = all(t[n]["digest"] == turns[0][n]["digest"]
               for t in turns for n in names)
    bad = sum(t[n]["bad_blocks"] for t in turns for n in names)
    sides = {"old": turns[0::3], "new": turns[1:3]}
    summary = {"same_outputs": same, "bad_blocks": bad,
               "card": turns[0]["card"]}
    for n in names:
        rate = next((k for k in turns[0][n] if k.endswith("_per_s")),
                    "call_s")
        stage_names = sorted({s for t in turns for m in t[n]["stage_ms"]
                              for s in m})
        summary[n] = {
            rate: {side: [r for t in ts for r in t[n][rate]]
                   for side, ts in sides.items()},
            "call_s_median": {side: _median([r for t in ts
                                             for r in t[n]["call_s"]])
                              for side, ts in sides.items()},
            "stage_ms_median": {
                side: {s: _median([m.get(s, 0.0) for t in ts
                                   for m in t[n]["stage_ms"]])
                       for s in stage_names}
                for side, ts in sides.items()}}
    print(json.dumps(summary))
    return 0 if same and not bad else 1


def _launch_row(fn, args, kw, reps) -> dict:
    """One kernel launch's outputs digested, then `reps` launches timed
    after a round that brings the clocks up."""
    out = fn(*args, **kw)
    out = out if isinstance(out, tuple) else (out,)
    digest = _digest(o for o in out if o is not None)
    _timed(lambda: fn(*args, **kw), reps)
    return {"ms": _timed(lambda: fn(*args, **kw), reps), "digest": digest}


def _takes(fn, name) -> bool:
    return name in inspect.signature(fn).parameters


def _decode_rows(cs, reps, calls) -> tuple:
    """The decode kernels that share the encode coders' headers, at
    chip_smoke.py's launches, and `calls` stage splits of a decode_states
    call on the wvc corpus (ms per stage)."""
    import torch

    from wvpk_torch.engine.staging import bucket_tensors, group_blocks
    from wvpk_torch.ops.decorr_cuda import decorr_post_cuda, \
        decorr_post_wvc_cuda
    from wvpk_torch.ops.entropy_cuda import entropy_decode_cuda, \
        entropy_decode_wvc_cuda
    from wvpk_torch.ops.wvc_cuda import wvc_corrections_cuda

    dev = torch.device("cuda")
    rows = {}

    def bucket(states):
        b = max(group_blocks(states), key=lambda x: len(x.states))
        return b, bucket_tensors(b, dev)

    def chain_kw(fn, b):
        kw = dict(mono=b.profile.mono)
        if _takes(fn, "static_terms"):
            kw.update(static_terms=b.static_terms,
                      chain_segments=b.chain_segments)
        return kw

    files, _ = cs.make_corpus()
    b, t = bucket(cs.parse_corpus(files, cs.N_FILES)[0])
    args, kw = cs._entropy_io(t, b.profile)
    res = entropy_decode_cuda(*args, hybrid=False, **kw)[0]
    rows["decorr_chain"] = dict(lanes=len(b.states), **_launch_row(
        decorr_post_cuda, cs._decorr_args(t, res),
        chain_kw(decorr_post_cuda, b), reps))
    del t, res

    files, _ = cs.make_hybrid()
    b, t = bucket(cs.parse_corpus(files, len(files) * cs.HYBRID_COPIES)[0])
    args, kw = cs._entropy_io(t, b.profile)
    rows["entropy_hybrid"] = dict(lanes=len(b.states), **_launch_row(
        entropy_decode_cuda, args, dict(kw, hybrid=True), reps))
    del t

    pairs, _ = cs.make_wvc()
    b, t = bucket(cs.parse_corpus(pairs, len(pairs) * cs.WVC_COPIES)[0])
    args, kw = cs._entropy_io(t, b.profile)
    rows["entropy_wvc"] = dict(lanes=len(b.states), **_launch_row(
        entropy_decode_wvc_cuda, args, kw, reps))
    res, mc, base, _broke, _ = entropy_decode_wvc_cuda(*args, **kw)
    rows["wvc"] = dict(lanes=len(b.states), **_launch_row(
        wvc_corrections_cuda, (t["wvc_words"], mc, base, res), {}, reps))
    corr = wvc_corrections_cuda(t["wvc_words"], mc, base, res)
    rows["decorr_wvc"] = dict(lanes=len(b.states), **_launch_row(
        decorr_post_wvc_cuda, (res, corr) + cs._decorr_args(t, res)[1:],
        chain_kw(decorr_post_wvc_cuda, b), reps))
    del t, res, mc, base, corr
    states = cs.parse_corpus(pairs, len(pairs) * cs.WVC_COPIES)[0]
    stages = [{k: 1000 * v for k, v in cs.stage_breakdown(states, dev).items()}
              for _ in range(calls)]
    return rows, stages


def measure_encode(root: str, reps: int, calls: int) -> dict:
    """One `--encode` turn: `root`'s word coders, the decode kernels that
    share their headers, and encode_device on the encode track."""
    cs = _import_root(root)
    import torch

    from wvpk_torch import trace
    from wvpk_torch.encode import build_spec, encode_device
    from wvpk_torch.engine.device_encoder import stage_lanes
    from wvpk_torch.ops import encode_cuda as ec

    dev = torch.device("cuda")
    track = cs.track_head()
    modes = (("lossless", {}),
             ("hybrid", dict(hybrid=True, bitrate=cs.ENC_BITRATE)))
    kernels = {}
    invert = cs._flat(ec.decorr_invert_cuda)
    for key, pcm, opts in (
            ("invert_mono64", cs.small_file("mono")[0], {}),
            ("invert_high64", cs.track_head(64 * cs.ENC_BLOCK),
             dict(preset="high"))):
        lanes = cs.stage_variant(pcm[:64 * cs.ENC_BLOCK], dev, **opts)
        args, kw, _n, _o = cs._enc_launches(lanes, "invert")
        kernels[key] = dict(lanes=len(lanes.starts), kwargs=sorted(kw),
                            **_launch_row(invert, args, kw, reps))
    for mode, opts in modes:
        lanes = stage_lanes(track, build_spec(
            track, block_samples=cs.ENC_BLOCK, **opts), cs.ENC_WARMUP, dev)
        if mode == "lossless":
            for key, warm in (("invert_warm", True), ("invert", False)):
                args, kw, _n, _o = cs._enc_launches(lanes, "invert", warm)
                kernels[key] = dict(lanes=len(lanes.starts),
                                    steps=int(args[0].shape[0]),
                                    kwargs=sorted(kw),
                                    **_launch_row(invert, args, kw, reps))
                kernels[key + "64"] = dict(lanes=64, **_launch_row(
                    invert, cs._lane_prefix(args, 64), kw, reps))
            if _takes(ec.decorr_invert_cuda, "static_terms"):
                kernels["invert_generic"] = dict(
                    lanes=len(lanes.starts), **_launch_row(
                        invert, args, dict(kw, static_terms=None), reps))
            lanes.t["residuals"] = ec.decorr_invert_cuda(*args, **kw)
            kind, fn = "words", ec.encode_words_cuda
        else:
            kind, fn = "hybrid", ec.hybrid_encode_cuda
        args, kw, _n, _o = cs._enc_launches(lanes, kind)
        if kind == "hybrid" and _takes(fn, "static_terms"):
            kw = dict(kw, static_terms=tuple(lanes.spec.terms))
        kernels[kind] = dict(lanes=len(lanes.starts), kwargs=sorted(kw),
                             **_launch_row(fn, args, kw, reps))
        kernels[kind + "64"] = dict(lanes=64, **_launch_row(
            fn, cs._lane_prefix(args, 64), kw, reps))
        del lanes, args
    wvc_stages = []
    if calls:
        rows, wvc_stages = _decode_rows(cs, reps, calls)
        kernels.update(rows)
    e2e = {}
    for mode, opts in modes if calls else ():
        rates, stages, wv = [], [], None
        for rep in range(calls + 1):
            wv = None
            with trace.collect() as st:
                t0 = time.perf_counter()
                wv = encode_device(track, device=dev,
                                   block_samples=cs.ENC_BLOCK,
                                   warmup=cs.ENC_WARMUP, **opts)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            if rep:
                rates.append(len(track) / dt / 1e6)
                stages.append({k: 1000 * v
                               for k, v in st.seconds().items()})
        e2e[mode] = {"msamples_per_s": rates, "stage_ms": stages,
                     "digest": hashlib.sha256(wv).hexdigest()[:16]}
    return {"root": root, "kernels": kernels, "encode_device": e2e,
            "wvc_decode_stage_ms": wvc_stages,
            "card": torch.cuda.get_device_name(0)}


def ab_encode(old: str, new: str, reps: int, calls: int) -> int:
    turns = []
    for root in (old, new, new, old):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root,
             "--encode-turn", "--reps", str(reps), "--calls", str(calls)],
            capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(turn))
        turns.append(turn)
    names = [n for n in turns[1]["kernels"] if n not in turns[0]["kernels"]]
    names = list(turns[0]["kernels"]) + names
    both = [n for n in names if all(n in t["kernels"] for t in turns)]
    digests = [{**{name: t["kernels"][name]["digest"] for name in both},
                **{mode: row["digest"]
                   for mode, row in t["encode_device"].items()}}
               for t in turns]
    same = all(d == digests[0] for d in digests)
    sides = {"old": turns[0::3], "new": turns[1:3]}
    modes = list(turns[0]["encode_device"])
    print(json.dumps({
        "same_outputs": same, "rows_compared": both,
        "kernel_ms": {name: {side: [t["kernels"].get(name, {}).get("ms")
                                    for t in ts]
                             for side, ts in sides.items()}
                      for name in names},
        "encode_msamples_per_s": {
            mode: {side: [r for t in ts
                          for r in t["encode_device"][mode]["msamples_per_s"]]
                   for side, ts in sides.items()}
            for mode in modes},
        "encode_stage_ms_median": {
            mode: {side: {s: _median([m[s] for t in ts
                                      for m in t["encode_device"][mode][
                                          "stage_ms"]])
                          for s in turns[0]["encode_device"][mode][
                              "stage_ms"][0]}
                   for side, ts in sides.items()}
            for mode in modes},
        "wvc_decode_stage_ms_median": {
            side: {s: _median([m[s] for t in ts
                               for m in t["wvc_decode_stage_ms"]])
                   for s in (turns[0]["wvc_decode_stage_ms"] or [{}])[0]}
            for side, ts in sides.items()}}))
    return 0 if same else 1


def _wvx_args(cs, bucket, dev) -> tuple:
    """The wvx kernel's arguments at `bucket` as the pipeline gives them:
    the root's entropy and decorrelation kernels' outputs, muted lanes
    masked."""
    from wvpk_torch.engine.staging import bucket_tensors
    from wvpk_torch.ops.decorr_cuda import decorr_post_cuda
    from wvpk_torch.ops.entropy_cuda import entropy_decode_cuda
    from wvpk_torch.ops.post import mask_muted

    t = bucket_tensors(bucket, dev)
    prof = bucket.profile
    args, kw = cs._entropy_io(t, prof)
    res, broke, _ = entropy_decode_cuda(*args, **kw, hybrid=prof.hybrid)
    dkw = {k: getattr(bucket, k) for k in ("static_terms", "chain_segments")
           if _takes(decorr_post_cuda, k)}
    dec, _crc, first_bad = decorr_post_cuda(*cs._decorr_args(t, res),
                                            mono=prof.mono, **dkw)
    dec, _ = mask_muted(dec, t["nsamples"], broke, first_bad)
    fs = t["false_stereo"] if t["false_stereo"].any() else None
    return (dec, t["nsamples"], t["wvx_words"], t["wvx_start_bit"],
            t["wvx_start_bc"], t["sent_bits"], t["max_width"],
            t["int32_zod"], fs)


def measure_wvx(root: str, reps: int, calls: int) -> dict:
    """One `--wvx` turn: `root`'s wvx kernel and decode_states on its
    int32+wvx corpus."""
    cs = _import_root(root)
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from wvpk_torch import _build
    from wvpk_torch.engine import decode_states
    from wvpk_torch.engine.staging import group_blocks
    from wvpk_torch.ops.wvx_cuda import wvx_inject_cuda

    dev = torch.device("cuda")
    with ProcessPoolExecutor(
            max_workers=cs.POOL_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        made = list(pool.map(cs.make_wvx, range(len(cs.WVX_FILES))))
    files, pcms = [m[0] for m in made], [m[1] for m in made]
    n_files = len(files) * cs.WVX_COPIES
    states, _ = cs.parse_corpus(files, n_files)
    frames = cs._frames(pcms, n_files)
    b = max(group_blocks(states), key=lambda x: len(x.states))
    kernels = {}
    for key, bucket in (("bucket", b),
                        ("lanes64", group_blocks(b.states[:64])[0])):
        args = _wvx_args(cs, bucket, dev)
        kernels[key] = dict(lanes=len(bucket.states),
                            **_launch_row(wvx_inject_cuda, args, {}, reps))
    rates, results = [], None
    for rep in range(calls + 1):
        results = None
        t0 = time.perf_counter()
        results = decode_states(states, dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rep:
            rates.append(frames / dt / 1e6)
    bad = sum(r.crc_error or r.mute_error for r in results)
    h = hashlib.sha256()
    for r in results:
        h.update(r.samples.tobytes())
    results = None
    stages = [{k: 1000 * v for k, v in cs.stage_breakdown(states, dev).items()}
              for _ in range(calls)]
    ptxas = [ln.strip() for ln in _build.ptxas_log.get("wvx", "").splitlines()
             if "registers" in ln or "stack frame" in ln]
    return {"root": root, "kernels": kernels, "msamples_per_s": rates,
            "bad_blocks": bad, "decode_digest": h.hexdigest()[:16],
            "stage_ms": stages, "ptxas": ptxas,
            "card": torch.cuda.get_device_name(0)}


def ab_wvx(old: str, new: str, reps: int, calls: int) -> int:
    turns = []
    for root in (old, new, new, old):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, "--wvx-turn",
             "--reps", str(reps), "--calls", str(calls)],
            capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(turn))
        turns.append(turn)
    digests = [{**{k: row["digest"] for k, row in t["kernels"].items()},
                "decode": t["decode_digest"]} for t in turns]
    same = all(d == digests[0] for d in digests)
    sides = {"old": turns[0::3], "new": turns[1:3]}
    stage_names = list(turns[0]["stage_ms"][0]) if calls else []
    print(json.dumps({
        "same_outputs": same,
        "bad_blocks": sum(t["bad_blocks"] for t in turns),
        "kernel_ms": {key: {side: [t["kernels"][key]["ms"] for t in ts]
                            for side, ts in sides.items()}
                      for key in turns[0]["kernels"]},
        "msamples_per_s": {side: [r for t in ts for r in t["msamples_per_s"]]
                           for side, ts in sides.items()},
        "stage_ms_median": {
            side: {s: _median([m[s] for t in ts for m in t["stage_ms"]])
                   for s in stage_names}
            for side, ts in sides.items()},
        "ptxas": {side: [ln for t in ts for ln in t["ptxas"]]
                  for side, ts in sides.items()}}))
    return 0 if same and not any(t["bad_blocks"] for t in turns) else 1


def _built(root: str, names) -> dict:
    """Build `root`'s sources `names` in a process of its own (its
    wvpk_torch first on the path); their libraries' paths by name."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from wvpk_torch import _build; _build.build_all(sys.argv[2:]); "
            "print(json.dumps({n: _build._so_path(n) "
            "for n in sys.argv[2:]}))")
    out = subprocess.run([sys.executable, "-c", code, os.path.abspath(root),
                          *names], capture_output=True, text=True,
                         check=True, timeout=900)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _sass(path: str, label) -> dict:
    """{kernel label: its instructions} of a built library (cuobjdump
    -sass), each instruction's address and encoding dropped."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, cur = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = label(m.group(1))
            while name in funcs:
                name += "'"
            cur = funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s*(.*?)\s*/\* 0x", ln)
        if m and cur is not None:
            cur.append(m.group(1))
    return funcs


def sass(old: str, new: str) -> int:
    """`--sass`: the two roots' SASS_SOURCES kernels, instruction for
    instruction."""
    label = _import_root(new)._kernel_label
    libs = {root: _built(root, SASS_SOURCES) for root in (old, new)}
    report, same = {}, True
    for name in SASS_SOURCES:
        a, b = (_sass(libs[r][name], label) for r in (old, new))
        row = {"identical": sorted(k for k in a if b.get(k) == a[k]),
               "differ": sorted(k for k in a if k in b and b[k] != a[k]),
               "old_only": sorted(set(a) - set(b)),
               "new_only": sorted(set(b) - set(a)),
               "instructions": [sum(map(len, a.values())),
                                sum(map(len, b.values()))]}
        same &= not (row["differ"] or row["old_only"] or row["new_only"])
        report[name] = row
    print(json.dumps({"sass": report, "identical": same}))
    return 0


def _side_in_group_order(dp, groups, staged):
    """decode_groups' side streams with the groups launched in their
    order of appearance (mode 1 first on the corpus), not mode 3 first."""
    import torch

    coded = [k for k, g in enumerate(groups) if g.prof.mode != 0]
    main = torch.cuda.current_stream()
    side = [torch.cuda.Stream() for _ in coded]
    for stream in side:
        stream.wait_stream(main)
    res = [None] * len(groups)
    for stream, k in zip(side, coded):
        with torch.cuda.stream(stream):
            res[k] = dp.decode_group(groups[k], staged[k])
    for stream in side:
        main.wait_stream(stream)
    return [r if r is not None else dp.decode_group(g, t)
            for r, g, t in zip(res, groups, staged)]


def dsd_streams(root: str, reps: int, calls: int) -> int:
    """`--dsd ROOT`: the DSD groups on side streams against in sequence
    (chip_smoke.dsd_side_vs_sequence, `calls` times), then the call's
    launch order (mode 3 first) against the groups' own order, in turns."""
    cs = _import_root(root)
    import torch

    from wvpk_torch.engine import dsd_pipeline as dp

    dev = torch.device("cuda")
    states, _vals, _groups = _dsd_corpus(cs)
    runs = [cs.dsd_side_vs_sequence(states, dev) for _ in range(calls)]
    groups = dp.group_dsd(states)
    staged = [dp.group_tensors(g, dev) for g in groups]

    def mode3_first():
        return dp.decode_groups(groups, staged)

    def group_order():
        return _side_in_group_order(dp, groups, staged)

    same = all(torch.equal(a, b) for x, y in zip(mode3_first(),
                                                group_order())
               for a, b in zip(x, y) if a is not None)
    order = {"mode3_first": [], "group_order": []}
    for fn in (mode3_first, group_order, group_order, mode3_first) * 2:
        order[fn.__name__].append(_timed(fn, reps))
    print(json.dumps({"dsd_streams": runs, "launch_order_ms": order,
                      "same_outputs": same,
                      "card": torch.cuda.get_device_name(0)}))
    return 0 if same else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old", nargs="?")
    ap.add_argument("new", nargs="?")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--runs", metavar="ROOT",
                    help="time the lane-run launches of ROOT's kernels")
    ap.add_argument("--dsd", action="store_true",
                    help="the DSD corpus: OLD NEW in turns, or one root's "
                    "side streams against the sequence")
    ap.add_argument("--turn", action="store_true",
                    help="measure the root OLD in this process")
    ap.add_argument("--dsd-turn", action="store_true",
                    help="measure the root OLD's DSD path in this process")
    ap.add_argument("--encode", action="store_true",
                    help="the encode track: OLD NEW in turns")
    ap.add_argument("--encode-turn", action="store_true",
                    help="measure the root OLD's encode path in this "
                    "process")
    ap.add_argument("--wvx", action="store_true",
                    help="the int32+wvx corpus: OLD NEW in turns")
    ap.add_argument("--wvx-turn", action="store_true",
                    help="measure the root OLD's wvx path in this process")
    ap.add_argument("--e2e", action="store_true",
                    help="decode_states on the lossless, DSD and mixed "
                    "calls: OLD NEW in turns")
    ap.add_argument("--e2e-turn", action="store_true",
                    help="measure the root OLD's decode_states calls in "
                    "this process")
    ap.add_argument("--store", action="store_true",
                    help="a library-shaped bucket's delivery: OLD NEW in "
                    "turns")
    ap.add_argument("--store-turn", action="store_true",
                    help="measure the root OLD's delivery in this process")
    ap.add_argument("--very-high", action="store_true",
                    help="the very high chains' decorrelation kernel: OLD "
                    "NEW in turns")
    ap.add_argument("--very-high-turn", action="store_true",
                    help="measure the root OLD's very high kernel in this "
                    "process")
    ap.add_argument("--sass", action="store_true",
                    help="compare OLD's and NEW's SASS of SASS_SOURCES")
    a = ap.parse_args()
    if a.runs:
        return runs(a.runs, a.reps)
    if a.sass:
        if not (a.old and a.new):
            ap.error("--sass takes OLD_ROOT and NEW_ROOT")
        return sass(a.old, a.new)
    if a.turn:
        print(json.dumps(measure(a.old, a.reps, a.calls)))
        return 0
    if a.dsd_turn:
        print(json.dumps(measure_dsd(a.old, a.reps, a.calls)))
        return 0
    if a.encode_turn:
        print(json.dumps(measure_encode(a.old, a.reps, a.calls)))
        return 0
    if a.store_turn:
        print(json.dumps(measure_store(a.old, a.reps)))
        return 0
    if a.very_high_turn:
        print(json.dumps(measure_very_high(a.old, a.reps)))
        return 0
    if a.very_high:
        if not (a.old and a.new):
            ap.error("--very-high takes OLD_ROOT and NEW_ROOT")
        return ab_very_high(a.old, a.new, a.reps)
    if a.store:
        if not (a.old and a.new):
            ap.error("--store takes OLD_ROOT and NEW_ROOT")
        return ab_store(a.old, a.new, a.reps)
    if a.e2e_turn:
        print(json.dumps(measure_e2e(a.old, a.calls)))
        return 0
    if a.e2e:
        if not (a.old and a.new):
            ap.error("--e2e takes OLD_ROOT and NEW_ROOT")
        return ab_e2e(a.old, a.new, a.calls)
    if a.wvx_turn:
        print(json.dumps(measure_wvx(a.old, a.reps, a.calls)))
        return 0
    if a.wvx:
        if not (a.old and a.new):
            ap.error("--wvx takes OLD_ROOT and NEW_ROOT")
        return ab_wvx(a.old, a.new, a.reps, a.calls)
    if a.encode:
        if not (a.old and a.new):
            ap.error("--encode takes OLD_ROOT and NEW_ROOT")
        return ab_encode(a.old, a.new, a.reps, a.calls)
    if a.dsd and a.old and not a.new:
        return dsd_streams(a.old, a.reps, a.calls)
    if a.dsd and a.new:
        return ab_dsd(a.old, a.new, a.reps, a.calls)
    if not (a.old and a.new):
        ap.error("give OLD_ROOT and NEW_ROOT, or --runs ROOT")
    return ab(a.old, a.new, a.reps, a.calls)


if __name__ == "__main__":
    sys.exit(main())
