#!/usr/bin/env python3
"""Smoke run of wvpk_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. the card's name and power limit (nvidia-smi, a plain line);
  2. build every CUDA kernel from wvpk_torch/csrc, one nvcc per source, all
     started together; ptxas' registers, stack frame and spill bytes of
     each kernel (every compiled decorrelation chain, both word coders and
     every hybrid and invert chain kernel, both correction-scan kernels
     and both wvx kernels must have neither stack nor spills to be in
     registers, or the run fails; the invert's, the correction scan's and
     the wvx kernels' registers are listed by kernel); the two encode sources with a kernel per chain,
     the longest builds, run beside phases 3-7 and are joined (their own
     build line) before phase 8;
  3. lossless: each kernel against its plain PyTorch version on the card,
     bit-exact, at the full bucket (the main path's shape) and launched on
     a 64-lane slice, both timed; then the bench corpus (192 files of 4 s
     16-bit stereo at 44.1 kHz, 16 distinct signals encoded with
     wvpk_torch.testgen, each repeated 12 times) through
     wvpk_torch.engine.decode_states: one
     warm-up and three timed repeats; 0 CRC errors, 0 mutes, sample-exact
     against the source PCM, the scalar oracle (wvpk_torch.ref) agreeing on
     probe blocks, both kernels launched by that run, each call exactly
     2 entropy and 2 decorrelation launches, both of the latter through
     the kernel compiled for the (18, 17, 2) chain and none through the
     generic one; the generic kernel timed beside it on the same bucket;
     one run split into its stages. Then the entropy kernel on 64 lanes
     of edge streams for each profile (wvpk_torch/testgen/edge.py:
     lossless, hybrid plain / HYBRID_BITRATE / HYBRID_BALANCE, stereo and
     mono, with and without the wvc outputs), against its plain version
     on a CPU copy, the correction-stream kernel on the wvc profiles'
     outputs too (lanes whose .wvc is cut short among them, which must
     run past their stream); and the mixed-chain corpus (MIX_FILES files of 4 s on
     each of the bench chain, the three encoder presets and one chain
     outside the table, ~430 lanes in one bucket sorted into one run per
     chain): its decorrelation kernels against their plain versions on a
     CPU copy (the wvc arm too, on corrections made from a seed),
     synthetic mixed buckets running every compiled chain, stereo and
     mono, with and without the wvc arm, then decode_states, sample-exact,
     each table chain's kernel and the generic one launched; then the very
     high corpus (VH_FILES files of 4 s on WavPack's 16-term very high
     chain, a block of each written mono, repeated to VH_COPIES): its
     kernels against their plain versions (the chain's cluster kernel,
     both stores) and decode_states, sample-exact, every lane on the very
     high chains' kernels; at the very high library cell's bucket shape
     (1,925 lanes of 44,100 samples) the cluster kernel against the
     generic one on the same lanes, equal, both timed beside the default
     chain's kernel on a bucket of that shape, and the SM of each CTA of
     a launch in the cluster kernel's shape, none shared;
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
     the corrections applied to every block; then the correction-stream
     kernel on 64 edge lanes, stereo and mono (wvpk_torch/testgen/edge.py::
     wvc_edge_lanes: maxcodes of every bit length, base + code past int32,
     rows read past their last word's start), against its plain version
     on a CPU copy;
  6. float (8 signals x 9) and int32+wvx (4 files x 18, several sent_bits,
     max_width 0 and 30; the wvx injection kernel against its plain
     version at the bucket and on 64 lanes, none in its int64 body):
     decode_states sample-exact against the source, 0 CRC errors (crc_x
     included), exactly one wvx launch a call; then the wvx kernel on 64
     edge lanes of 320 samples, stereo and mono with FALSE_STEREO lanes
     (wvpk_torch/testgen/edge.py::wvx_edge_lanes: every sent_bits class,
     truncations, start_bc of both signs, cursors past the row's end,
     every re-expansion arm, lanes outside its 32-bit range), against its
     plain version on a CPU copy, its int64 body running exactly the
     lanes outside that range;
  7. DSD, at the JAX bench's DSD shape (4,096 byte-samples a block, stereo
     DSD64, 2.8224 MHz): three groups of 8 one-second signals, 87 blocks
     each (696 lanes a group, 2,088 in all): mode 1 with 4 history bins,
     mode 1 with 32 and mode 3; in each group 6 signals are first-order
     sigma-delta modulations of two tones plus noise and 2 are uniform
     random bytes (the coders' worst case); one mono file each for modes
     1 and 3 and one mode-0 file run the other instantiations and the raw
     CRC. Each DSD kernel at the full group and launched on its first
     64 lanes and on 64 lanes of a random signal, all timed, held against
     its plain version, which runs in the worker pool on the group's host
     arrays while the card goes on (checked once phase 8 is done; mode 3
     with 0 lanes in its int64 body),
     then decode_states as in 3 (0 CRC errors, 0 mutes,
     byte-exact against the source bytes, the scalar oracle on probe
     blocks, exactly 3 mode-1 and 2 mode-3 launches a call), the rate in
     byte-values/s and as a realtime factor of DSD64 stereo; the groups
     on side streams (the main path) against the groups in sequence:
     equal outputs, both timed; one call mixing 16 lossless files
     with the DSD corpus, right in both parts from its one batched copy;
     a stage split; then each DSD kernel on 64 edge lanes per profile
     (wvpk_torch/testgen/edge.py: mode 1 with 1, 4 and 32 bins and mode 3,
     stereo and mono) against its plain version on a CPU copy, mode 3's
     int64 body running exactly the lanes staged outside its 32-bit
     range;
  8. device encode: the encode corpus is the lossless corpus' 192 source
     arrays one after another, a 768 s 16-bit stereo track (33,868,800
     frames, 8,269 blocks of 4,096: 8,269 lanes), at the bench's
     settings (the default preset, warm seeding over 512 samples). Each
     encode kernel against its plain version on the card at the main
     path's launch (the warm and the main invert through the default
     chain's kernel, the word coder, the hybrid scan at HYBRID_BITRATE
     through the default chain's kernel, and the run-time kernels of both
     inverts and of the hybrid scan on the same lanes), timed, and
     launched on its first 64 lanes, timed and held against the plain
     outputs of those lanes, the word coders' int64-body lanes counted
     (0); the other
     instantiations (hybrid with HYBRID_BALANCE, without HYBRID_BITRATE
     and mono, the hybrid chain kernels of the fast, default and high
     presets, stereo and mono, and the run-time kernel; every invert
     chain kernel, the bench chain's too, stereo and mono, and the
     run-time kernel on stereo, on mono and on a mono chain with cross
     terms, each also with the final state from the staged seeds)
     launched on 64 lanes, each through the kernel its chain must run, and
     held against their plain versions run on a CPU copy of the inputs in
     the worker pool; each word coder on 64 edge lanes of each kind and profile
     (wvpk_torch/testgen/edge.py::encode_edge_lanes; the hybrid ones
     through their chain's kernel and the run-time kernel) against its
     plain version run in the worker pool, the int64 body running exactly
     the lanes staged outside int32, and the hybrid edge lanes' targets,
     chains and seeds through the invert the same two ways, with and
     without the final state. Then
     encode_device on the track, lossless and hybrid (bitrate 512): one
     warm-up and two timed calls, the launch counts read per kernel
     instance (exactly, a lossless call: the default chain's invert and
     its invert with the final state once each, 1 word coder; a hybrid
     call: the default chain's invert with the state and its hybrid
     kernel once each; never a run-time kernel), the last call split into
     its trace stages, one more lossless call under torch.profiler for
     the device's idle share, the output decoded by decode_states on
     the card (0 CRC errors, 0 mutes; lossless sample-exact with its
     stored MD5 the source's, hybrid the oracle agreeing on probe
     blocks). Five small files (64 blocks of the track, mono, float,
     32-bit routed to wvx, 5.1 at 24 bits) encode on the card and, in the
     worker pool, on the CPU: the bytes must be identical;
  9. `python -m wvpk_torch.cli --encode` on the track and the four small
     files as WAVs, then the CLI's decode of those five .wv files, a
     lossless file, a hybrid file beside its .wvc and a float file: each
     .wav must equal its source WAV (or the WAV header plus the source
     samples) byte for byte; and with --raw on a mode-3 DSD file, whose
     output must equal the source bytes;
 10. lane sharding and chunked delivery (wvpk_torch/parallel,
     DecodeOptions.delivery_chunk_blocks): the multi-device dry run
     (wvpk_torch/parallel/dryrun.py, every codec family bit-exact against
     the oracle) on two entries of the card, and the mesh of every visible
     GPU (make_mesh()); sharded_decode_states on two entries against
     decode_states on the mixed-chain, wvc, wvx and DSD corpora (the same
     blocks, the decorrelation instantiations launched exactly those that
     each shard's cut chain runs name, every shard of the mixed-chain
     corpus on a table chain's kernel; the DSD wrappers' host reads
     counted), and the mixed-chain corpus on the visible mesh;
     encode_device sharded over two entries on 64 blocks of the encode
     track, lossless and hybrid, byte-equal to the unsharded call, each
     coder launched once a shard; the lossless corpus through
     decode_states with delivery_chunk_blocks 0 and 512 in eight turns
     (0, 512, 512, 0, 0, 512, 512, 0; a warm-up and three timed calls
     each): the same blocks, the rates, each stage's median, the transfer
     counts and launches of a call, beside the card's name and power
     limit; the GPU
     differential sweep (wvpk_torch/testgen/fuzzspec.py::run_hw_sweep,
     bench.py's counts: 40 PCM, 8 DSD, 4 multichannel and 4 wvc cases)
     unsharded and on two entries of the card, 0 mismatches each.
Then a JSON line of per-kernel results (each with its bound: the bytes
its function must move over the H100's 3.35 TB/s, each input read once
and each output written once, counting what the lanes hold and not the
padding, a delivered output at its delivered width (PCM samples at their
bytes per sample, DSD byte-values at 1 byte) and of mode 1's tables the
rows the data visits; the integer coders do no floating-point work, so
bytes set the bound) and, last, the device JSON line.

Counts of kernel launches are set to 0 just before each decode_states,
sharded_decode_states or encode_device phase and read just after it; launches made to compare
a kernel with its plain version do not count. A plain version's time grows with its steps,
not its lanes (one small op per step, whatever the lane count), so it
runs once, at the full bucket; a 64-lane launch is held against the
plain outputs of its lanes, and only a slice from another bucket (the
hybrid phase's HYBRID_BALANCE slice) runs the plain versions again.

Needs one CUDA device; exits non-zero, printing no result, without one or
when any phase fails. Imports no jax. Writes only under build/ in the
checkout.
"""

from __future__ import annotations

import json
import math
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
# the wvx files: (int32_sent_bits, int32_max_width, amplitude bits); the
# values stay narrower than max_width, so no sent bit is truncated
WVX_FILES = ((4, 0, 27), (6, 30, 28), (8, 0, 29), (5, 30, 27))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# launches of at most this many lanes that are held against their plain
# version run it on a CPU copy of the inputs: the plain versions are one
# small op a step, which the host's CPU dispatches faster than it launches
# and synchronises CUDA kernels
CPU_PLAIN_LANES = 128
# worker processes beside the main one, whose plain versions are bound by
# the host's dispatch: the card's machine has 8 CPU cores
POOL_WORKERS = 3
# DSD: DSD64 (1-bit samples a second per channel), 4096 byte-samples a
# block (bench.py:644); per group 8 one-second signals, the last 2 random
# bytes; the groups: (name, mode, history_bits)
DSD_RATE, DSD_BLOCK, DSD_SIGNALS, DSD_RANDOM = 2822400, 4096, 8, 2
DSD_GROUPS = (("dsd_fast_bins4", 1, 2), ("dsd_fast_bins32", 1, 5),
              ("dsd_high", 3, None))
# the extra files: (name, mode, mono, history_bits)
DSD_EXTRA = (("dsd_fast_mono", 1, True, 2), ("dsd_high_mono", 3, True, None),
             ("dsd_raw", 0, False, None))
DSD64_STEREO_BYTEVALS_PER_S = DSD_RATE // 8 * 2   # 705,600
# device encode at the bench's shape: 4096-sample blocks, the default
# preset, warm seeding over 512 samples, hybrid at bitrate 512; the small
# files of the CUDA-vs-CPU check are 10 s, the variant launches 64 lanes
ENC_BLOCK, ENC_WARMUP, ENC_BITRATE = 4096, 512, 512
ENC_CALLS = 3    # encode_device calls a mode: one warm-up, then timed
ENC_SMALL_SECONDS, ENC_SLICE_BLOCKS = 10.0, 64
ENC_SMALL = ("track_slice", "mono", "float", "int32_wvx", "mc51_24bit")
# the mixed-chain corpus: MIX_FILES files of 4 s 16-bit stereo on each of
# the decorrelation kernels' table chains (the bench chain and the encoder
# presets) and on one chain outside the table; the lanes of one bucket
MIX_CHAINS = (("bench", (18, 17, 2)), ("fast", (17, 17)),
              ("default", (18, 18, 2, 17, 3)),
              ("high", (18, 18, 18, -2, 2, 3, 5, -1, 17, 4)),
              ("outside", (3, 17, -3, 2)))
MIX_FILES = 2
# the very high corpus: VH_FILES files of SECONDS 16-bit stereo on the
# very high chain (wavpack -hh, 16 terms), each with one block of equal
# channels written mono (FALSE_STEREO, the mono chain), repeated to
# VH_COPIES files; and the very high library cell's bucket shape (PERF.md
# section 4): LIB_LANES stereo lanes of LIB_BLOCK samples (libwavpack's
# block for -hh at 44.1 kHz), LIB_DISTINCT blocks repeated
VH_FILES, VH_COPIES = 4, 48
LIB_LANES, LIB_BLOCK, LIB_DISTINCT = 1925, 44100, 16
# the entropy kernel's edge streams: lanes per profile
# (wvpk_torch/testgen/edge.py)
EDGE_LANES = 64


def corpus_pcms(n_distinct=N_DISTINCT, seconds=SECONDS, seed=SEED):
    """The bench headline corpus' signals (bench.py::_generate_corpus):
    `n_distinct` 16-bit stereo arrays."""
    rng = np.random.default_rng(seed)
    n = int(44100 * seconds)
    t = np.arange(n)
    pcms = []
    for i in range(n_distinct):
        f0 = 220 * (1 + (i % 7))
        sig = (6000 * np.sin(2 * np.pi * f0 * t / 44100)
               + 2500 * np.sin(2 * np.pi * 2.01 * f0 * t / 44100)
               + rng.normal(0, 400, n))
        pcm = np.stack([np.round(sig),
                        np.round(sig * 0.8 + rng.normal(0, 200, n))],
                       axis=1).astype(np.int64)
        np.clip(pcm, -32768, 32767, out=pcm)
        pcms.append(pcm)
    return pcms


def make_corpus(n_distinct=N_DISTINCT, n_files=N_FILES, seconds=SECONDS,
                seed=SEED):
    """The bench headline corpus: `n_distinct` encoded files, repeated to
    `n_files`. Returns (files, pcms), one entry per distinct file; file k
    of the corpus is files[k % n_distinct]."""
    from wvpk_torch.testgen import EncodeSpec, encode_file

    pcms = corpus_pcms(n_distinct, seconds, seed)
    return [encode_file(pcm, EncodeSpec(**SPEC)) for pcm in pcms], pcms


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
    from wvpk_torch.testgen import EncodeSpec, encode_file

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
    from wvpk_torch.testgen import EncodeSpec, encode_file

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
    wvpk_torch.testgen (not wvpk.encode) to the specs wvpk.encode gives them:
    HYBRID_BITRATE at bitrates 256..970, the fast (17, 17) and default
    (18, 18, 2, 17, 3) chains in turn. Returns ([(wv, wvc)], pcms)."""
    from wvpk_torch.testgen import EncodeSpec
    from wvpk_torch.testgen.encoder import encode_blocks

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
    from wvpk_torch.testgen import EncodeSpec, encode_file

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
    from wvpk_torch.testgen import EncodeSpec, encode_file

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
    from wvpk_torch.container import parse_blocks
    from wvpk_torch.container.blocks import pair_wvc

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


def _steady_ms(fn, warm_ms=20.0, min_ms=10.0, min_reps=5) -> float:
    """Mean device time of `fn` at the card's steady clocks: one launch
    sizes the runs, launches of at least `warm_ms` in all bring the clocks
    up, then at least `min_reps` launches and `min_ms` are timed. On an
    NVIDIA H100 80GB HBM3 at 700 W the wvx kernel read 0.14-0.17 ms from 5
    launches after the host's plain run, 0.10 ms from 20 after 20
    (PERF.md)."""
    one = max(_events_ms(fn, 1), 1e-3)
    _events_ms(fn, max(1, math.ceil(warm_ms / one)))
    return _events_ms(fn, max(min_reps, math.ceil(min_ms / one)))


def _tensor_bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _outputs(res) -> tuple:
    """A function's outputs as a tuple (wvc_corrections returns one
    tensor, the others a tuple)."""
    return res if isinstance(res, tuple) else (res,)


def _moved_bytes(args, got, need=None, out_need=None) -> int:
    """The bytes a launch must move: each input once and each output once,
    at its tensor's size unless `need` (inputs) or `out_need` (outputs)
    maps its index to what the lanes hold, at the delivered width."""
    need, out_need = need or {}, out_need or {}
    return sum(need[i] if i in need else _tensor_bytes(a)
               for i, a in enumerate(args)) \
        + sum(out_need[i] if i in out_need else _tensor_bytes(g)
              for i, g in enumerate(_outputs(got)))


def check_pair(name, kernel, plain, args, kw, timed, run_plain=True,
               need=None, out_need=None, plain_cpu=False, steady=False):
    """`kernel` against `plain` on the same inputs; raises on any
    difference. Returns (the kernel's outputs, the plain version's or
    None, {max_abs_err, ms, plain_ms, bytes, bound_ms}); ms (CUDA events:
    5 launches, or _steady_ms with `steady`) only when `timed`, the plain
    version timed once on the host clock and left out (None) when not
    `run_plain`; with `plain_cpu` the plain version runs on a CPU copy of
    the inputs (its outputs are returned on the card). `bytes` counts
    each input once and each output once, at its tensor's size unless
    `need` (inputs) or `out_need` (outputs) maps its index to the bytes
    the function must move: what the lanes hold, at the delivered
    width."""
    got = kernel(*args, **kw)
    _sync()
    nbytes = _moved_bytes(args, got, need, out_need)
    res = {"max_abs_err": None, "ms": None, "plain_ms": None,
           "bytes": nbytes, "bound_ms": 1000 * nbytes / HBM_BYTES_PER_S}
    want = None
    if run_plain:
        pargs = [a.cpu() if plain_cpu and isinstance(a, torch.Tensor) else a
                 for a in args]
        t0 = time.perf_counter()
        want = plain(*pargs, **kw)
        _sync()
        res["plain_ms"] = 1000 * (time.perf_counter() - t0)
        if plain_cpu:
            res["plain_device"] = "cpu"
            want = tuple(w.to(g.device) for w, g in zip(_outputs(want),
                                                        _outputs(got)))
        pairs = list(zip(_outputs(want), _outputs(got)))
        for i, (w, g) in enumerate(pairs):
            if not torch.equal(w, g):
                raise AssertionError(
                    f"{name} kernel != plain version: output {i}")
        res["max_abs_err"] = max(_max_abs_err(w, g) for w, g in pairs)
    if timed:
        res["ms"] = (_steady_ms(lambda: kernel(*args, **kw)) if steady
                     else _events_ms(lambda: kernel(*args, **kw), 5))
    return got, want, res


def check_prefix(name, want, got) -> int:
    """A launch on a prefix of a bucket's lanes (`got`) against the plain
    outputs of the whole bucket (`want`): each output of `got` must equal
    the same-shaped leading block of its counterpart (lanes, steps and
    rows are prefixes; padding past a lane's counts is 0 in both).
    Returns the max abs error (0); raises on any difference."""
    err = 0
    for i, (w, g) in enumerate(zip(_outputs(want), _outputs(got))):
        w = w[tuple(slice(0, n) for n in g.shape)]
        if not torch.equal(w, g):
            raise AssertionError(f"{name}: the 64-lane launch differs from "
                                 f"the plain version, output {i}")
        err = max(err, _max_abs_err(w, g))
    return err


def _chain_blind(plain):
    """A plain decorrelation that takes (and, computing the same function,
    ignores) the kernels' static_terms / chain_segments."""
    def run(*args, static_terms=None, chain_segments=None, **kw):
        return plain(*args, **kw)
    return run


def _plain_packed(*args, pack, **kw):
    """ops/decorr.py::decorr_post_packed with `pack`'s tensors on the
    device of the inputs (check_pair moves only the arguments to the
    CPU)."""
    from wvpk_torch.ops import decorr

    dev = args[0].device
    pack = pack._replace(broke=pack.broke.to(dev), shift=pack.shift.to(dev))
    return _chain_blind(decorr.decorr_post_packed)(*args, pack=pack, **kw)


def _kernels():
    """The kernel wrappers and their plain versions, by name."""
    from wvpk_torch.ops import decorr, decorr_cuda, dsd, dsd_cuda, \
        entropy, entropy_cuda, post, wvc_cuda, wvx_cuda

    return {
        "entropy": (entropy_cuda.entropy_decode_cuda,
                    entropy.entropy_decode),
        "entropy_wvc": (entropy_cuda.entropy_decode_wvc_cuda,
                        lambda *a, **k: entropy.entropy_decode(
                            *a, hybrid=True, wvc=True, **k)),
        "decorr": (decorr_cuda.decorr_post_cuda, _chain_blind(
            decorr.decorr_post)),
        "decorr_packed": (decorr_cuda.decorr_post_cuda, _plain_packed),
        "decorr_wvc": (decorr_cuda.decorr_post_wvc_cuda, _chain_blind(
            decorr.decorr_post_wvc)),
        "wvc": (wvc_cuda.wvc_corrections_cuda, entropy.wvc_corrections),
        "wvx": (wvx_cuda.wvx_inject_cuda, post.wvx_inject),
        "dsd_fast": (dsd_cuda.dsd_fast_decode_cuda,
                     dsd.dsd_fast_decode_bytes),
        "dsd_high": (dsd_cuda.dsd_high_decode_cuda,
                     dsd.dsd_high_decode_bytes),
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


def compare_bucket(bucket, device, timed, run_plain=True, plain_cpu=None):
    """Each kernel of the bucket's decode against its plain version on
    the same inputs (the kernels' outputs feed the next step): lossless
    buckets run the entropy and decorrelation kernels, hybrid buckets the
    entropy kernel's hybrid profile; a bucket of pipeline.packed_route
    (lossless or hybrid) also the decorrelation kernel's packed store, the
    one its decode launches (`decorr_packed`, against
    ops/decorr.py::decorr_post_packed: payload, CRC and first_bad), while
    `decorr` is the (T, L, C) store; wvc buckets the entropy kernel's wvc
    profile, the correction scan and the decorrelation kernel's wvc arm,
    wvx buckets the wvx injection (its entropy and decorrelation kernels
    only feed it: the lossless phase holds them). Returns ({kernel name:
    {max_abs_err, ms, plain_ms, bytes, bound_ms}}, {kernel name: (its
    outputs, the plain version's or None)})."""
    from wvpk_torch.engine.pipeline import _bucket_bps, packed_route
    from wvpk_torch.engine.staging import bucket_tensors
    from wvpk_torch.ops.decorr import Pack
    from wvpk_torch.ops.post import mask_muted

    if plain_cpu is None:
        plain_cpu = len(bucket.states) <= CPU_PLAIN_LANES
    k = _kernels()
    t = bucket_tensors(bucket, device)
    prof = bucket.profile
    args, kw = _entropy_io(t, prof)
    sts = bucket.states
    # the bytes the lanes hold: each lane's stream; its samples as int32
    # (residuals, corrections, intervals) and at the width the decode
    # delivers them (bytes per sample; 4 for float)
    words = {0: sum(len(st.wvbits or b"") for st in sts)}
    values = int(bucket.nsamples.sum()) * (1 if prof.mono else 2)
    samples = 4 * values
    delivered = (_bucket_bps(bucket) or 4) * values
    # the decorrelation kernels run per chain, as the pipeline runs them
    dkw = dict(mono=prof.mono, static_terms=bucket.static_terms,
               chain_segments=bucket.chain_segments)
    out, io = {}, {}

    def pair(key, name, args, kw, held, **need):
        got, want, res = check_pair(name, *k[key], args, kw, timed and held,
                                    run_plain and held, plain_cpu=plain_cpu,
                                    steady=key == "wvx", **need)
        if held:
            out[key], io[key] = res, (got, want)
        return got

    if prof.has_wvc:
        res, mc, base, broke, _ = pair(
            "entropy_wvc", "entropy[hybrid_wvc]", args, kw, True,
            need=words, out_need={0: samples, 1: samples, 2: samples})
        corr = pair("wvc", "wvc_corrections",
                    (t["wvc_words"], mc, base, res), {}, True,
                    need={0: sum(len(st.wvcbits or b"") for st in sts),
                          1: samples, 2: samples, 3: samples},
                    out_need={0: samples})
        dargs = _decorr_args(t, res)
        pair("decorr_wvc", "decorr_post[wvc]",
             dargs[:1] + (corr,) + dargs[1:], dkw, True,
             need={0: samples, 1: samples}, out_need={0: delivered})
    else:
        hold = not prof.has_wvx
        res, broke, _ = pair("entropy", "entropy", args,
                             dict(kw, hybrid=prof.hybrid), hold, need=words,
                             out_need={0: samples})
        if not prof.hybrid:
            dec, _crc, first_bad = pair(
                "decorr", "decorr_post", _decorr_args(t, res), dkw, hold,
                need={0: samples},
                out_need={0: delivered})
        bps = packed_route(bucket)
        if bps is not None:
            pack = Pack(broke, t["shift"], bps, prof.hybrid)
            pair("decorr_packed", "decorr_post[packed]", _decorr_args(t, res),
                 dict(dkw, pack=pack), True, need={0: samples},
                 out_need={0: delivered})
    if broke.any():
        raise AssertionError("corpus lanes hit an EOF break")
    if prof.has_wvx:
        dec, _ = mask_muted(dec, t["nsamples"], broke, first_bad)
        fs = t["false_stereo"] if t["false_stereo"].any() else None
        pair("wvx", "wvx_inject",
             (dec, t["nsamples"], t["wvx_words"], t["wvx_start_bit"],
              t["wvx_start_bc"], t["sent_bits"], t["max_width"],
              t["int32_zod"], fs), {}, True,
             need={0: samples, 2: sum(len(st.wvxbits or b"") for st in sts)},
             out_need={0: delivered})
        out["wvx"]["int64_lanes"] = int(k["wvx"][0].wide_lanes)
    return out, io


def compare_phase(name, states, device, slice_of=None):
    """compare_bucket at the phase's largest bucket (the main path's
    shape), timed, then each kernel launched on a 64-lane slice, timed.
    The slice comes from that bucket and is held against the full run's
    plain outputs of its lanes, or from the bucket `slice_of(buckets)`
    picks (another profile), which runs the plain versions itself."""
    from wvpk_torch.engine.staging import group_blocks

    buckets = group_blocks(states)
    b = max(buckets, key=lambda x: len(x.states))
    full, io = compare_bucket(b, device, True)
    print(json.dumps({"phase": f"{name}_kernels_vs_plain_full_bucket",
                      "profile": _profile_name(b.profile),
                      "buckets": [len(x.states) for x in buckets],
                      "lanes": len(b.states), "T": b.profile.nsamples_cap,
                      "words_per_lane": int(b.words.shape[1]),
                      "results": full}))
    src = slice_of(buckets) if slice_of else b
    own = src is not b
    slice64, io64 = compare_bucket(group_blocks(src.states[:64])[0], device,
                                   True, run_plain=own)
    if not own:
        for k, (got, _want) in io64.items():
            slice64[k]["max_abs_err"] = check_prefix(
                f"{name} {k}", io[k][1], got)
    print(json.dumps({"phase": f"{name}_kernels_vs_plain_64_lanes",
                      "profile": _profile_name(src.profile),
                      "plain": "own run" if own else "the full bucket's",
                      "results": slice64}))
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
    from wvpk_torch.ops import decorr_cuda, dsd_cuda, entropy_cuda, \
        wvc_cuda, wvx_cuda

    return {"entropy": entropy_cuda.entropy_decode_cuda,
            "entropy_wvc": entropy_cuda.entropy_decode_wvc_cuda,
            "decorr": decorr_cuda.decorr_post_cuda,
            "decorr_wvc": decorr_cuda.decorr_post_wvc_cuda,
            "wvc": wvc_cuda.wvc_corrections_cuda,
            "wvx": wvx_cuda.wvx_inject_cuda,
            "dsd_fast": dsd_cuda.dsd_fast_decode_cuda,
            "dsd_high": dsd_cuda.dsd_high_decode_cuda}


def _reset(counters):
    """Every launch count to 0, the decorrelation kernels' counts of each
    instantiation too."""
    for fn in counters.values():
        fn.launches = 0
        for k in getattr(fn, "chain_launches", {}):
            fn.chain_launches[k] = 0


def _instances():
    """The launches of each decorrelation kernel instantiation, keyed
    "decorr:<chain>" and "decorr_wvc:<chain>" (ops/decorr_cuda.py)."""
    from wvpk_torch.ops import decorr_cuda

    return {f"{key}:{name}": n
            for key, fn in (("decorr", decorr_cuda.decorr_post_cuda),
                            ("decorr_wvc", decorr_cuda.decorr_post_wvc_cuda))
            for name, n in fn.chain_launches.items() if n}


def decode_phase(name, states, frames, device, expect, check,
                 rate_key="msamples_per_s", realtime=None):
    """decode_states on the phase's corpus: every launch count set to 0,
    one warm-up and three timed calls, the counts read; each kernel in
    `expect` must have launched. `check(results)` raises on a wrong
    result and returns a dict for the phase line. The rate is `frames`
    per second in millions; with `realtime` (frames a second of audio)
    also as a realtime factor."""
    from wvpk_torch.engine import decode_states

    counters = _counters()
    _reset(counters)
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
    launches.update(_instances())
    info = check(results)
    if realtime:
        info["realtime_x"] = [r * 1e6 / realtime for r in rates]
    print(json.dumps({"phase": f"{name}_decode_states", "warmup": 1,
                      rate_key: rates, "frames": frames,
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
    from wvpk_torch.ref import decode_block

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


def run_cli(files, device, raw=False):
    """The CLI on several files in one process: `files` maps a name to
    (.wv bytes, .wvc bytes or None, expected output bytes). Each output
    (a .wav, or with `raw` the container-less bytes the CLI writes under
    the same name) must equal its expected bytes."""
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
         str(device), *(["--raw"] if raw else [])], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"CLI exited {proc.returncode}: {proc.stderr}")
    for name, (_wv, _wvc, want) in files.items():
        with open(os.path.join(work, name + ".wav"), "rb") as f:
            if f.read() != want:
                raise AssertionError(f"CLI output of {name} differs from "
                                     "the expected bytes")
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
    from wvpk_torch.engine.pipeline import packed_route
    from wvpk_torch.engine.staging import group_blocks

    t0 = time.perf_counter()
    files, pcms = make_corpus()
    states, per_file = parse_corpus(files, N_FILES)
    frames = _frames(pcms, N_FILES)
    _corpus_line("lossless", files, N_FILES, states, frames, t0)
    # every bucket's decode launches the packed store, so the (T, L, C)
    # store's row counts no launch of the decode calls
    if not all(packed_route(b) for b in group_blocks(states)):
        raise AssertionError("lossless: a bucket is not packed")
    full = compare_phase("lossless", states, dev)
    full["decorr_generic"] = generic_decorr(states, dev, full["decorr"])
    launches = decode_phase("lossless", states, frames, dev,
                            ("entropy", "decorr"),
                            check_exact(states, per_file, pcms))
    # 4 calls, each 2 buckets: 2 entropy launches and 2 of the (18, 17, 2)
    # decorrelation kernel a call, never the generic one
    want = {"entropy": 8, "decorr": 8, "decorr:bench": 8}
    if {k: launches.get(k, 0) for k in want} != want \
            or launches.get("decorr:generic", 0):
        raise AssertionError(f"lossless: launches {launches}, expected "
                             f"{want} and no generic decorrelation")
    print(json.dumps({"phase": "lossless_stage_seconds",
                      "stages": stage_breakdown(states, dev)}))
    return full, launches, (files, pcms), states


def generic_decorr(states, device, chain_row):
    """The lossless bucket's decorrelation through the generic kernel
    (each lane's chain read at run time) beside the kernel compiled for
    its chain, on the same residuals: the outputs equal (the chain
    kernel's were held against the plain version), both timed in turns
    (chain, generic, generic, chain). Returns the generic row (the plain
    time and bound are the chain row's: the same function and inputs)."""
    from wvpk_torch.engine.staging import bucket_tensors, group_blocks
    from wvpk_torch.ops.decorr_cuda import decorr_post_cuda
    from wvpk_torch.ops.entropy_cuda import entropy_decode_cuda

    b = max(group_blocks(states), key=lambda x: len(x.states))
    t = bucket_tensors(b, device)
    args, kw = _entropy_io(t, b.profile)
    res = entropy_decode_cuda(*args, hybrid=False, **kw)[0]
    dargs = _decorr_args(t, res)
    mono = b.profile.mono

    def chain():
        return decorr_post_cuda(*dargs, mono=mono,
                                static_terms=b.static_terms)

    def generic():
        return decorr_post_cuda(*dargs, mono=mono)

    want, got = chain(), generic()
    _sync()
    err = max(_max_abs_err(w, g) for w, g in zip(want, got))
    if err or not all(torch.equal(w, g) for w, g in zip(want, got)):
        raise AssertionError("generic decorr kernel != chain kernel")
    turns = [_events_ms(fn, 5) for fn in (chain, generic, generic, chain)]
    return {"max_abs_err": err, "ms": (turns[1] + turns[2]) / 2,
            "ms_turns": turns[1:3], "chain_ms_turns": [turns[0], turns[3]],
            "plain_ms": chain_row["plain_ms"], "bytes": chain_row["bytes"],
            "bound_ms": chain_row["bound_ms"],
            "static_terms": list(b.static_terms)}


def phase_entropy_edges(dev, jobs):
    """The entropy kernel on EDGE_LANES lanes of edge streams per profile
    (testgen/edge.py), against its plain version on a CPU copy: every
    output equal, some lanes broken and some not. On the wvc profiles the
    correction-stream kernel then takes the entropy kernel's wvc outputs,
    against its plain version on a CPU copy; the lanes whose .wvc is cut
    short (edge.py::WVC_CUT_EVERY) must need more bits than their stream
    holds (edge.py::wvc_min_bits), so their cursors run past it."""
    from wvpk_torch.engine.staging import bucket_tensors, group_blocks
    from wvpk_torch.testgen.edge import WVC_CUT_EVERY, wvc_min_bits

    k = _kernels()
    results = {}
    for profile, fut in jobs.items():
        (b,) = group_blocks(fut.result())
        t = bucket_tensors(b, dev)
        args, kw = _entropy_io(t, b.profile)
        key = "entropy_wvc" if b.profile.has_wvc else "entropy"
        if key == "entropy":
            kw = dict(kw, hybrid=b.profile.hybrid)
        got, want, res = check_pair(f"entropy edge streams {profile}",
                                    *k[key], args, kw, True,
                                    plain_cpu=True)
        broke = want[-2]
        if not broke.any() or broke.all():
            raise AssertionError(f"edge streams {profile}: broken lanes "
                                 f"{int(broke.sum())} of {len(broke)}")
        res.update(lanes=len(b.states), words_per_lane=int(b.words.shape[1]),
                   broke_lanes=int(broke.sum()))
        if key == "entropy_wvc":
            cres, mc, base = got[:3]
            _c, _w, wres = check_pair(f"wvc edge streams {profile}",
                                      *k["wvc"], (t["wvc_words"], mc, base,
                                                  cres), {}, True,
                                      plain_cpu=True)
            bits = np.asarray([8 * len(st.wvcbits) for st in b.states])
            cut = np.arange(len(bits)) % WVC_CUT_EVERY == 0
            least = wvc_min_bits(mc.cpu().numpy())
            if not cut.any() or (least[cut] <= bits[cut]).any():
                raise AssertionError(f"wvc edge streams {profile}: no row "
                                     f"runs out ({least[cut]} bits read, "
                                     f"{bits[cut]} in the .wvc)")
            wres.update(cut_lanes=int(cut.sum()),
                        cut_lane_bits=bits[cut].tolist(),
                        cut_lane_least_bits_read=least[cut].tolist())
            res["wvc"] = wres
        results[profile] = res
    print(json.dumps({"phase": "entropy_edge_streams_vs_plain_on_cpu",
                      "results": results}))


def make_mixed(k):
    """File k of the mixed-chain corpus: 4 s of 16-bit stereo (a tone pair
    and noise) on chain MIX_CHAINS[k // MIX_FILES]. Runs in a worker
    process. Returns (file, pcm)."""
    from wvpk_torch.testgen import EncodeSpec, encode_file

    _name, terms = MIX_CHAINS[k // MIX_FILES]
    pcm = _tone_pair(1700 + k, 180 + 60 * k, 5000 + 500 * k, 300 + 40 * k,
                     0.7, 32768, int(44100 * SECONDS))
    return encode_file(pcm, EncodeSpec(block_samples=4096, joint=True,
                                       terms=terms,
                                       deltas=(2,) * len(terms))), pcm


def synthetic_chains(mono, T=256, lanes=64, seed=77):
    """The decorrelation inputs of a mixed-chain bucket made from a seed:
    `lanes` lanes on each table chain (ops/decorr_cuda.py::CHAINS) of the
    channel count, on a chain outside the table, and on random chains (a
    generic tail); random residuals, weights, histories, sample counts,
    joint flags and mute limits, some low enough to fire. Returns (CPU
    tensors in decorr_post's argument order, chain_segments)."""
    from wvpk_torch.ops.decorr_cuda import CHAINS

    rng = np.random.default_rng(seed + mono)
    C = 1 if mono else 2
    chains = [c for _n, m, c in CHAINS if m == mono] + [(3, 17, 2)]
    runs = chains + [None]
    L = lanes * len(runs)
    terms = np.zeros((L, 16), np.int32)
    nt = np.zeros(L, np.int32)
    segs = []
    pool = [1, 2, 3, 4, 5, 6, 7, 8, 17, 18] + ([] if mono else [-1, -2, -3])
    for r, chain in enumerate(runs):
        lo = r * lanes
        for i in range(lo, lo + lanes):
            c = chain if chain else tuple(rng.choice(pool, rng.integers(
                0, 17)))
            terms[i, :len(c)] = c
            nt[i] = len(c)
        segs.append((chain, lo, lo + lanes,
                     len(chain) if chain else max(int(nt[lo:].max()), 1)))
    deltas = np.where(np.arange(16)[None, :] < nt[:, None],
                      rng.integers(0, 8, (L, 16)), 0).astype(np.int32)
    arrays = [rng.integers(-2**14, 2**14, (T, L, C)).astype(np.int32),
              terms, deltas,
              rng.integers(-2**10, 2**10, (L, 16)).astype(np.int32),
              rng.integers(-2**10, 2**10, (L, 16)).astype(np.int32),
              rng.integers(-2**15, 2**15, (L, 16, 8)).astype(np.int64),
              rng.integers(-2**15, 2**15, (L, 16, 8)).astype(np.int64),
              nt, rng.integers(T // 2, T + 1, L).astype(np.int32),
              rng.integers(0, 2, L).astype(bool),
              np.where(rng.random(L) < 0.2, 2**13, 2**40).astype(np.int64)]
    return [torch.from_numpy(a) for a in arrays], tuple(segs)


def check_synthetic_chains(dev):
    """Every table chain, stereo and mono, with and without the wvc arm,
    and the generic kernel, on synthetic_chains' buckets through their
    chain_segments: equal to the plain version on the CPU."""
    k = _kernels()
    results = {}
    for mono in (False, True):
        args, segs = synthetic_chains(mono)
        corr = torch.from_numpy(np.random.default_rng(78 + mono).integers(
            -2**12, 2**12, tuple(args[0].shape)).astype(np.int32))
        kw = dict(mono=mono, chain_segments=segs)
        for key, a in (("decorr", args),
                       ("decorr_wvc", [args[0], corr] + args[1:])):
            on_card = [x.to(dev) for x in a]
            _got, _want, res = check_pair(
                f"{key} synthetic chains", *k[key], on_card, kw, True,
                plain_cpu=True)
            name = f"{key}[{'mono' if mono else 'stereo'}]"
            results[name] = {"lanes": int(a[0].shape[1]),
                             "steps": int(a[0].shape[0]),
                             "max_abs_err": res["max_abs_err"],
                             "ms": res["ms"], "plain_ms": res["plain_ms"]}
    return results


def phase_mixed(dev, futures):
    """The mixed-chain corpus: its largest bucket's decorrelation kernels
    against their plain versions on a CPU copy (one run per chain; the
    (T, L, C) store, the packed store the decode launches, and the wvc
    arm on the same residuals with corrections made from a seed),
    synthetic mixed buckets for every table chain, then
    decode_states as in 3, each table chain's kernel and the generic one
    launched. Returns ({kernel: results}, launches)."""
    from wvpk_torch.engine.pipeline import packed_route
    from wvpk_torch.engine.staging import bucket_tensors, group_blocks
    from wvpk_torch.ops.decorr import Pack
    from wvpk_torch.ops.decorr_cuda import lane_runs

    t0 = time.perf_counter()
    got = [f.result() for f in futures]
    files, pcms = [g[0] for g in got], [g[1] for g in got]
    states, per_file = parse_corpus(files, len(files))
    frames = _frames(pcms, len(files))
    _corpus_line("mixed_chains", files, len(files), states, frames, t0)
    buckets = group_blocks(states)
    b = max(buckets, key=lambda x: len(x.states))
    if b.chain_segments is None:
        raise AssertionError("the mixed-chain bucket has no segments")
    # the residuals from the entropy kernel (held on the lossless bucket)
    t = bucket_tensors(b, dev)
    args, ekw = _entropy_io(t, b.profile)
    res, broke, _ = _kernels()["entropy"][0](*args, hybrid=False, **ekw)
    corr = torch.from_numpy(np.random.default_rng(79).integers(
        -2**12, 2**12, tuple(res.shape)).astype(np.int32)).to(dev)
    dargs = _decorr_args(t, res)
    kw = dict(mono=b.profile.mono, chain_segments=b.chain_segments)
    values = int(b.nsamples.sum()) * (1 if b.profile.mono else 2)
    # every bucket's decode launches the packed store (the (T, L, C)
    # store's row counts no launch of the decode calls)
    bps = packed_route(b)
    if not all(packed_route(x) for x in buckets):
        raise AssertionError("mixed chains: a bucket is not packed")
    pack = Pack(broke, t["shift"], bps, b.profile.hybrid)
    full = {}
    for key, a, need, akw in (
            ("decorr", dargs, {0: 4 * values}, kw),
            ("decorr_packed", dargs, {0: 4 * values}, dict(kw, pack=pack)),
            ("decorr_wvc", dargs[:1] + (corr,) + dargs[1:],
             {0: 4 * values, 1: 4 * values}, kw)):
        _got, _want, full[key] = check_pair(
            f"{key} mixed chains", *_kernels()[key], a, akw, True,
            need=need, out_need={0: bps * values}, plain_cpu=True)
    runs = lane_runs(len(b.states), b.profile.mono,
                     chain_segments=b.chain_segments)
    print(json.dumps({"phase": "mixed_chains_kernels_vs_plain_on_cpu",
                      "buckets": [len(x.states) for x in buckets],
                      "lanes": len(b.states), "T": b.profile.nsamples_cap,
                      "chain_segments": [[list(c) if c else None, s, e]
                                         for c, s, e, _n in b.chain_segments],
                      "kernel_runs": runs, "results": full,
                      "synthetic": check_synthetic_chains(dev)}))
    launches = decode_phase("mixed_chains", states, frames, dev,
                            ("entropy", "decorr"),
                            check_exact(states, per_file, pcms, probe=False))
    need = [f"decorr:{n}" for n in ("bench", "fast", "default", "high",
                                    "generic")]
    if min(launches.get(k, 0) for k in need) < 1:
        raise AssertionError(f"mixed chains: a kernel did not run: "
                             f"{launches}")
    return full, launches, states


def _chain(name):
    from wvpk_torch.ops.decorr_cuda import CHAINS

    (terms,) = [t for n, _m, t in CHAINS if n == name]
    return terms


def very_high_file(k, n=None):
    """File k of the very high corpus: a tone pair on the very high chain,
    deltas 2, joint stereo, 4,096-sample blocks; its second block's
    channels equal (the left one) and written mono on the mono chain, as
    `wavpack` writes such a block. Returns (bytes, pcm)."""
    from wvpk_torch.testgen import EncodeSpec
    from wvpk_torch.testgen.encoder import encode_blocks

    n = n or int(44100 * SECONDS)
    pcm = _tone_pair(1900 + k, 150 + 70 * k, 5000 + 700 * k, 300 + 50 * k,
                     0.6, 32768, n)
    blk = 4096
    pcm[blk:2 * blk, 1] = pcm[blk:2 * blk, 0]
    stereo, mono = _chain("very_high"), _chain("very_high_mono")
    data = []
    for terms, lo, hi in ((stereo, 0, blk), (mono, blk, 2 * blk),
                          (stereo, 2 * blk, n)):
        fs = terms is mono
        spec = EncodeSpec(block_samples=blk, joint=not fs, false_stereo=fs,
                          terms=terms, deltas=(2,) * len(terms),
                          total_samples_override=n)
        data += encode_blocks(pcm[lo:hi, :1] if fs else pcm[lo:hi], spec,
                              start_sample=lo, first=lo == 0, last=hi >= n)
    return b"".join(data), pcm


def library_bucket(chain, dev):
    """A bucket at the library cell's shape on `chain`: LIB_DISTINCT
    LIB_BLOCK-sample blocks of a tone over noise (16-bit stereo, joint,
    deltas 2) repeated to LIB_LANES lanes; its tensors on `dev` and the
    entropy kernel's residuals. Returns (bucket, its tensors, the entropy
    kernel's `broke`, the decorrelation kernel's arguments)."""
    from wvpk_torch.container import parse_blocks
    from wvpk_torch.engine.staging import bucket_tensors, group_blocks
    from wvpk_torch.ops.entropy_cuda import entropy_decode_cuda
    from wvpk_torch.testgen import EncodeSpec, encode_file

    pcm = _tone_pair(2100, 440, 6000, 800, 0.6, 32768,
                     LIB_BLOCK * LIB_DISTINCT)
    data = encode_file(pcm, EncodeSpec(block_samples=LIB_BLOCK, joint=True,
                                       terms=chain,
                                       deltas=(2,) * len(chain)))
    states = [b.state for b in parse_blocks(data)]
    (b,) = group_blocks((states * (LIB_LANES // len(states) + 1))
                        [:LIB_LANES])
    t = bucket_tensors(b, dev)
    args, kw = _entropy_io(t, b.profile)
    res, broke, _ = entropy_decode_cuda(*args, hybrid=False, **kw)
    return b, t, broke, _decorr_args(t, res)


def phase_very_high(dev):
    """WavPack's very high mode (16 terms): the corpus' kernels against
    their plain versions (compare_phase: the very high chain's cluster
    kernel, both stores), decode_states sample-exact with the oracle on
    probe blocks, every lane on the very high chains' kernels (the mono
    blocks' too), none on the generic one; then at the very high
    library cell's bucket shape the cluster kernel (the packed store the
    decode launches, and the (T, L, C) store) against the generic kernel
    on the same lanes, equal, both timed in turns, beside the default
    chain's kernel on a bucket of that shape; and the SM (%smid) of each
    CTA of a launch in the cluster kernel's shape at that bucket's lanes,
    every CTA resident at once, no SM shared. A traced decode of the
    corpus counts every lane as the cluster kernel's
    (`launch#cluster_lanes` = `launch#lanes`). Returns (results,
    launches)."""
    from wvpk_torch import trace
    from wvpk_torch.engine import decode_states
    from wvpk_torch.engine.pipeline import packed_route
    from wvpk_torch.ops.decorr import Pack
    from wvpk_torch.ops.decorr_cuda import cluster_sms, decorr_post_cuda

    t0 = time.perf_counter()
    got = [very_high_file(k) for k in range(VH_FILES)]
    files, pcms = [g[0] for g in got], [g[1] for g in got]
    states, per_file = parse_corpus(files, VH_COPIES)
    frames = _frames(pcms, VH_COPIES)
    _corpus_line("very_high", files, VH_COPIES, states, frames, t0)
    full = compare_phase("very_high", states, dev)
    launches = decode_phase("very_high", states, frames, dev,
                            ("entropy", "decorr"),
                            check_exact(states, per_file, pcms))
    need = ("decorr:very_high", "decorr:very_high_mono")
    if min(launches.get(k, 0) for k in need) < 1 \
            or launches.get("decorr:generic", 0) \
            or launches.get("decorr:generic_mono", 0):
        raise AssertionError(f"very high: launches {launches}, expected "
                             f"{need} and no generic decorrelation")
    with trace.collect() as sink:
        decode_states(states, dev)
    lanes = {k: sink[f"launch#{k}"]
             for k in ("lanes", "chain_lanes", "cluster_lanes")}
    print(json.dumps({"phase": "very_high_traced_lanes", **lanes}))
    if len(set(lanes.values())) != 1:
        raise AssertionError(f"very high: lanes {lanes}, expected every "
                             "lane on the cluster kernel")

    lib = {}
    for name in ("very_high", "default"):
        b, t, broke, dargs = library_bucket(_chain(name), dev)
        pack = Pack(broke, t["shift"], packed_route(b), False)
        runs = {"packed": dict(static_terms=b.static_terms, pack=pack),
                "unpacked": dict(static_terms=b.static_terms)}
        if name == "very_high":
            runs.update(generic_packed=dict(pack=pack), generic_unpacked={})
        fns = {k: (lambda kw=kw: decorr_post_cuda(*dargs, mono=False, **kw))
               for k, kw in runs.items()}
        if name == "very_high":
            for store in ("packed", "unpacked"):
                want, have = fns["generic_" + store](), fns[store]()
                _sync()
                if not all(torch.equal(w, h) for w, h in zip(want, have)):
                    raise AssertionError(f"very high {store} store at the "
                                         "library bucket != generic kernel")
                del want, have
        order = list(fns) + list(fns)[::-1]
        turns = {}
        for k in order:
            turns.setdefault(k, []).append(_events_ms(fns[k], 5))
        lib[name] = {"lanes": len(b.states), "T": b.profile.nsamples_cap,
                     "static_terms": list(b.static_terms), "ms": turns}
        del dargs, t
        torch.cuda.empty_cache()
    sm, seen = cluster_sms(LIB_LANES, False, dev)
    sm = sm.cpu().tolist()
    lib["cluster_ctas"] = {"ctas": len(sm), "sms": len(set(sm)),
                           "all_resident": bool(seen.all())}
    if len(set(sm)) != len(sm) or not lib["cluster_ctas"]["all_resident"]:
        raise AssertionError(f"cluster kernel's CTAs: {lib['cluster_ctas']}"
                             f", SMs {sm}")
    print(json.dumps({"phase": "very_high_library_bucket", **lib}))
    full["library_bucket"] = lib
    return full, launches


def phase_hybrid(dev):
    from wvpk_torch.engine.pipeline import packed_route
    from wvpk_torch.engine.staging import group_blocks

    t0 = time.perf_counter()
    files, pcms = make_hybrid()
    states, per_file = parse_corpus(files, len(files) * HYBRID_COPIES)
    frames = _frames(pcms, len(files) * HYBRID_COPIES)
    _corpus_line("hybrid", files, len(files) * HYBRID_COPIES, states,
                 frames, t0)
    # the decode's decorrelation launches are all the packed store's
    if not all(packed_route(b) for b in group_blocks(states)):
        raise AssertionError("hybrid: a bucket is not packed")
    # the 64-lane slice takes the HYBRID_BALANCE bucket, the full bucket
    # is the largest (HYBRID_BITRATE alone): both profiles are held
    full = compare_phase(
        "hybrid", states, dev, slice_of=lambda buckets: next(
            b for b in buckets if b.profile.hybrid_balance))
    mono_states, _ = parse_corpus(make_mono_hybrid(), 3)
    mono, _io = compare_bucket(max(group_blocks(mono_states),
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
    return full, launches, (pairs[0], pcms[0]), states


WVC_EDGE_SEED = 19


def phase_wvc_edges(dev):
    """The correction scan on EDGE_LANES wvc edge lanes
    (testgen/edge.py::wvc_edge_lanes), stereo and mono, against its plain
    version on a CPU copy: every output equal."""
    from wvpk_torch.testgen.edge import wvc_edge_lanes

    kernel, plain = _kernels()["wvc"]
    results = {}
    for mono in (False, True):
        name = "mono" if mono else "stereo"
        args = tuple(torch.from_numpy(a).to(dev) for a in wvc_edge_lanes(
            EDGE_LANES, WVC_EDGE_SEED, mono))
        _got, _want, res = check_pair(f"wvc edge lanes {name}", kernel,
                                      plain, args, {}, True, plain_cpu=True)
        results[name] = res
    print(json.dumps({"phase": "wvc_edge_lanes_vs_plain_on_cpu",
                      "lanes": EDGE_LANES, "results": results}))


# the wvx injection's edge lanes: the seed and the samples a lane
# (several of the kernel's 128-value chunks)
WVX_EDGE_SEED, WVX_EDGE_STEPS = 23, 320


def phase_wvx_edges(dev):
    """The wvx injection on EDGE_LANES wvx edge lanes
    (testgen/edge.py::wvx_edge_lanes), stereo and mono with FALSE_STEREO
    lanes, against its plain version on a CPU copy: every output equal,
    and the int64 body run on exactly the lanes int64_lanes names (some)."""
    from wvpk_torch.ops.wvx_cuda import int64_lanes
    from wvpk_torch.testgen.edge import wvx_edge_lanes

    kernel, plain = _kernels()["wvx"]
    results = {}
    for mono in (False, True):
        name = "mono_false_stereo" if mono else "stereo"
        *arrays, fs = wvx_edge_lanes(EDGE_LANES, WVX_EDGE_SEED, mono,
                                     steps=WVX_EDGE_STEPS)
        args = tuple(torch.from_numpy(a).to(dev) for a in arrays) \
            + ((torch.from_numpy(fs).to(dev) if fs.any() else None),)
        if mono != (args[-1] is not None):
            raise AssertionError("wvx edge lanes: FALSE_STEREO lanes "
                                 "must be the mono set's")
        _got, _want, res = check_pair(f"wvx edge lanes {name}", kernel,
                                      plain, args, {}, True, plain_cpu=True,
                                      steady=True)
        T, _L, C = args[0].shape
        want = int(int64_lanes(T, C, args[1], args[3], args[5],
                               args[8]).sum())
        res["int64_lanes"] = int(kernel.wide_lanes)
        if res["int64_lanes"] != want or want == 0:
            raise AssertionError(f"wvx edge lanes {name}: int64 body ran "
                                 f"{res['int64_lanes']} lanes, not {want}")
        results[name] = res
    print(json.dumps({"phase": "wvx_edge_lanes_vs_plain_on_cpu",
                      "lanes": EDGE_LANES, "T": WVX_EDGE_STEPS,
                      "results": results}))


def phase_float(dev):
    t0 = time.perf_counter()
    files, pcms, exps = make_float()
    states, per_file = parse_corpus(files, len(files) * FLOAT_COPIES)
    frames = _frames(pcms, len(files) * FLOAT_COPIES)
    _corpus_line("float", files, len(files) * FLOAT_COPIES, states, frames,
                 t0)
    decode_phase("float", states, frames, dev, ("entropy", "decorr"),
                 check_exact(states, per_file, pcms, probe=False))
    return files[0], pcms[0], exps[0]


def phase_wvx(dev, wvx_futures):
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
    # one launch a wvx bucket a call (4 calls), and the bucket's lanes all
    # in the 32-bit body
    from wvpk_torch.engine.staging import group_blocks

    want = 4 * sum(b.profile.has_wvx for b in group_blocks(states))
    if launches["wvx"] != want or full["wvx"]["int64_lanes"] != 0:
        raise AssertionError(f"wvx: {launches['wvx']} launches in 4 calls "
                             f"(want {want}), "
                             f"{full['wvx']['int64_lanes']} int64 lanes")
    phase_wvx_edges(dev)
    return full, launches, states


def sigma_delta(seed, n_bytes, mono=False):
    """DSD64 byte-samples (n_bytes, 1 or 2) uint8: each channel a
    first-order sigma-delta modulation (bits = diff(floor(cumsum((x +
    1) / 2)))) of two tones plus noise in [-0.5, 0.5], computed at the
    1-bit rate and packed MSB-first."""
    rng = np.random.default_rng(seed)
    n = 8 * n_bytes
    t = np.arange(n) / DSD_RATE
    chans = []
    for c in range(1 if mono else 2):
        f1, f2 = 300 + 97 * ((seed + c) % 11), 2500 + 331 * ((seed + c) % 7)
        x = (0.3 * np.sin(2 * np.pi * f1 * t)
             + 0.12 * np.sin(2 * np.pi * f2 * t) + rng.normal(0, 0.02, n))
        bits = np.diff(np.floor(np.cumsum((np.clip(x, -0.5, 0.5) + 1) / 2)),
                       prepend=0).astype(np.uint8)
        chans.append(np.packbits(bits, bitorder="big"))
    return np.stack(chans, axis=1)


def make_dsd(mode, history_bits, seed, random=False, mono=False):
    """One second of DSD64 encoded with wvpk_torch.testgen at 4096
    byte-samples a block: sigma-delta content, or uniform random bytes.
    Runs in a worker process. Returns (.wv bytes, source (n, ch))."""
    from wvpk_torch.testgen import encode_dsd_file

    n = DSD_RATE // 8
    if random:
        src = np.random.default_rng(seed).integers(
            0, 256, (n, 1 if mono else 2)).astype(np.uint8)
    else:
        src = sigma_delta(seed, n, mono)
    kw = {} if history_bits is None else {"history_bits": history_bits}
    return encode_dsd_file(src.astype(np.int64), mode, mono=mono,
                           block_samples=DSD_BLOCK, **kw), src


def submit_dsd(pool):
    """The DSD corpus' encodes, queued on the worker pool: {group name:
    [futures]}."""
    jobs = {}
    for g, (name, mode, hb) in enumerate(DSD_GROUPS):
        jobs[name] = [pool.submit(make_dsd, mode, hb, 9000 + 100 * g + i,
                                  i >= DSD_SIGNALS - DSD_RANDOM)
                      for i in range(DSD_SIGNALS)]
    for k, (name, mode, mono, hb) in enumerate(DSD_EXTRA):
        jobs[name] = [pool.submit(make_dsd, mode, hb, 9900 + k, False,
                                  mono)]
    return jobs


def _largest_dsd_group(states):
    from wvpk_torch.engine.dsd_pipeline import group_dsd

    groups = group_dsd(states)
    return max(groups, key=lambda g: len(g.sts)), groups


def _dsd_inputs(g, device):
    """A profile group's staged kernel inputs, as the pipeline stages
    them: (kernel and plain version, args, keywords)."""
    from wvpk_torch.engine.dsd_pipeline import group_tensors

    t = group_tensors(g, device)
    prof = g.prof
    if prof.mode == 1:
        return (_kernels()["dsd_fast"],
                (t["data"], t["nbytes"], t["summed"], t["value0"],
                 t["nvals"]),
                dict(bins=prof.bins, mono=prof.mono, nsteps=g.nsteps))
    return (_kernels()["dsd_high"],
            (t["data"], t["nbytes"], t["ptable"], t["filters"],
             t["value0"], t["nsamples"]), dict(mono=prof.mono,
                                               nsteps=g.nsteps))


def _visited_rows(codes, nvals, bins, lag):
    """Mode 1: how many (lane, history bin) table rows the decode of
    `codes` (L, W) uint8 reads. Step t reads the row of the code `lag`
    steps back (1 mono, 2 stereo; row 0 before that)."""
    L, W = codes.shape
    hist = codes.to(torch.int64) & (bins - 1)
    pos = torch.arange(W, device=codes.device)[None, :]
    used = (pos < nvals.to(torch.int64)[:, None] - lag).to(torch.int64)
    seen = torch.zeros(L, bins, dtype=torch.int64, device=codes.device)
    seen.scatter_add_(1, hist, used)
    seen[:, 0] += (nvals > 0).to(torch.int64)
    return int((seen > 0).sum())


def _dsd_need(g, args, codes):
    """The bytes a DSD launch must move (check_pair's need, out_need):
    each lane's payload bytes, its 32-bit counts and window, of mode 1's
    tables the rows the data visits (1 KB each), of mode 3 the ptable
    (1 KB a lane) and the f1..f6, factor words of its channels; out, its
    byte-values at 1 byte, crc (and err) per lane."""
    L = len(g.sts)
    C = 1 if g.prof.mono else 2
    need = {0: int(g.arrays["nbytes"].sum()), 1: 4 * L, 3: 4 * L}
    out_need = {0: int(g.nvals.sum())}
    if g.prof.mode == 1:
        need[2] = 1024 * _visited_rows(codes, args[4], g.prof.bins,
                                       1 if g.prof.mono else 2)
        need[4] = 4 * L
        out_need.update({1: L, 2: 4 * L})
    else:
        need.update({2: 1024 * L, 3: 28 * C * L, 4: 4 * L, 5: 4 * L})
        out_need[1] = 4 * L
    return need, out_need


def _dsd_slice(g, lo, n, device, kernel):
    """The kernel launched on lanes lo .. lo + n - 1 of group `g`: (its
    outputs, ms)."""
    from wvpk_torch.engine.dsd_pipeline import group_dsd

    (gs,) = group_dsd(g.sts[lo:lo + n])
    _pair, args, kw = _dsd_inputs(gs, device)
    got = kernel(*args, **kw)
    _sync()
    return got, _events_ms(lambda: kernel(*args, **kw), 5)


def _dsd_host_args(g):
    """A profile group's kernel arguments as the host arrays they are
    staged from, and its keywords."""
    a = g.arrays
    if g.prof.mode == 1:
        return ((g.data, a["nbytes"], a["summed"], a["value0"], a["nvals"]),
                dict(bins=g.prof.bins, mono=g.prof.mono, nsteps=g.nsteps))
    return ((g.data, a["nbytes"], a["ptable"], a["filters"], a["value0"],
             a["nsamples"]), dict(mono=g.prof.mono, nsteps=g.nsteps))


def plain_dsd(mode, arrays, kw):
    """A DSD group's plain decode on the CPU from its host arrays (numpy):
    (its outputs as numpy arrays, ms). Runs in a worker process."""
    from wvpk_torch.ops import dsd

    torch.set_num_threads(1)
    fn = dsd.dsd_fast_decode_bytes if mode == 1 else \
        dsd.dsd_high_decode_bytes
    t0 = time.perf_counter()
    out = fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays),
             **kw)
    return [o.numpy() for o in out], 1000 * (time.perf_counter() - t0)


def _launcher(kernel, args, kw):
    """The DSD kernel alone on `args` (its wrapper's checks made once):
    dsd_cuda.dsd_fast_launcher / dsd_high_launcher."""
    from wvpk_torch.ops import dsd_cuda

    if kernel is dsd_cuda.dsd_fast_decode_cuda:
        return dsd_cuda.dsd_fast_launcher(*args, **kw)
    return dsd_cuda.dsd_high_launcher(*args, **kw)


def _wide_lanes(kernel):
    """The lanes dsd_high's last launch ran in its int64 body (None for
    mode 1)."""
    from wvpk_torch.ops import dsd_cuda

    if kernel is not dsd_cuda.dsd_high_decode_cuda:
        return None
    return int(dsd_cuda.dsd_high_decode_cuda.wide_lanes)


def compare_dsd(name, states, device, pool):
    """The DSD kernel at the largest profile group of `states` (the main
    path's launch), timed (ms: the wrapper's call, its one read of the
    input limits included; kernel_ms: the kernel alone), then launched on
    the group's first 64 lanes (the first signal) and, in a group of
    DSD_SIGNALS files, on 64 lanes of its first random signal, each
    timed. The plain version runs once, at the full group, in the worker
    pool on the host arrays the group is staged from (a plain decoder's
    time grows with the steps, not the lanes: one small op per step), so
    the card goes on meanwhile. Returns a callable that waits for it,
    holds every launch against the plain outputs of its lanes and the
    CRCs against the headers, prints the phase line and returns {max_abs_err,
    ms, plain_ms, bytes, bound_ms, ...}. Mode 3 reports the lanes its
    int64 body ran (0 on the corpus)."""
    g, groups = _largest_dsd_group(states)
    (kernel, _plain), args, kw = _dsd_inputs(g, device)
    host_args, host_kw = _dsd_host_args(g)
    job = pool.submit(plain_dsd, g.prof.mode, host_args, host_kw)
    # one launch first: mode 1's bound counts the table rows its codes
    # visit (the codes are then held against the plain version)
    need, out_need = _dsd_need(g, args, kernel(*args, **kw)[0])
    got, _want, res = check_pair(name, kernel, None, args, kw, True,
                                 run_plain=False, need=need,
                                 out_need=out_need)
    wide = _wide_lanes(kernel)
    n = min(64, len(g.sts))
    slices = {"slice": (0, *_dsd_slice(g, 0, n, device, kernel))}
    res.update(kernel_ms=_events_ms(_launcher(kernel, args, kw), 5),
               lanes=len(g.sts), nsteps=g.nsteps,
               payload_cap=int(g.data.shape[1]), plain_lanes=len(g.sts),
               slice_lanes=n, int64_lanes=wide,
               profile_groups=[len(x.sts) for x in groups])
    if len(g.sts) >= DSD_SIGNALS * 64:
        lo = len(g.sts) // DSD_SIGNALS * (DSD_SIGNALS - DSD_RANDOM)
        slices["random_slice"] = (lo, *_dsd_slice(g, lo, 64, device,
                                                 kernel))
        res["random_slice_first_lane"] = lo

    def finish():
        outs, plain_ms = job.result()
        want = tuple(torch.from_numpy(w).to(device) for w in outs)
        pairs = list(zip(want, got))
        for i, (w, x) in enumerate(pairs):
            if not torch.equal(w, x):
                raise AssertionError(
                    f"{name} kernel != plain version: output {i}")
        res.update(max_abs_err=max(_max_abs_err(w, x) for w, x in pairs),
                   plain_ms=plain_ms, plain_device="cpu")
        hdr = torch.tensor([st.header.crc for st in g.sts],
                           dtype=torch.int32)
        if not torch.equal(got[-1].cpu(), hdr):
            raise AssertionError(f"{name}: kernel CRCs differ from the "
                                 "headers")
        if wide:
            raise AssertionError(f"{name}: {wide} lanes ran the int64 body")
        for key, (lo, out, ms) in slices.items():
            res[f"{key}_max_abs_err"] = check_prefix(
                f"{name} lanes {lo}..", tuple(w[lo:] for w in want), out)
            res[f"{key}_ms"] = ms
        print(json.dumps({"phase": f"{name}_kernel_vs_plain", **res}))
        return res
    return finish


def dsd_side_vs_sequence(states, device):
    """A call's DSD groups decoded on side streams (decode_groups, the
    main path) and one after another on the current stream: equal
    outputs; both timed with CUDA events, in turns side, sequence,
    sequence, side (ms a call, the wrappers' checks included), beside
    each group's own time."""
    from wvpk_torch.engine import dsd_pipeline as dp

    groups = dp.group_dsd(states)
    staged = [dp.group_tensors(g, device) for g in groups]

    def side():
        return dp.decode_groups(groups, staged)

    def sequence():
        return [dp.decode_group(g, t) for g, t in zip(groups, staged)]

    a, b = side(), sequence()
    _sync()
    for k, (x, y) in enumerate(zip(a, b)):
        for u, v in zip(x, y):
            if not ((u is None and v is None) or torch.equal(u, v)):
                raise AssertionError(f"DSD group {k}: side streams differ "
                                     "from the sequence")
    turns = [(fn.__name__, _events_ms(fn, 3))
             for fn in (side, sequence, sequence, side)]
    per_group = {f"mode{g.prof.mode}_{'mono' if g.prof.mono else 'stereo'}"
                 f"_bins{g.prof.bins}": _events_ms(
                     lambda g=g, t=t: dp.decode_group(g, t), 3)
                 for g, t in zip(groups, staged)}
    return {"side_ms": [ms for n, ms in turns if n == "side"],
            "sequence_ms": [ms for n, ms in turns if n == "sequence"],
            "group_ms": per_group}


def phase_dsd_edges(dev, jobs):
    """Each DSD kernel on 64 edge lanes per profile (testgen/edge.py),
    against its plain version on a CPU copy: out, err and crc equal, some
    lanes clean and some not; mode 3's int64 body ran exactly the lanes
    staged outside the 32-bit body's range."""
    from wvpk_torch.engine.dsd_pipeline import group_dsd

    results = {}
    for profile, fut in jobs.items():
        states = fut.result()
        (g,) = group_dsd(states)
        (kernel, plain), args, kw = _dsd_inputs(g, dev)
        _got, want, res = check_pair(f"dsd edge lanes {profile}", kernel,
                                     plain, args, kw, True, plain_cpu=True)
        hdr = torch.tensor([st.header.crc for st in states],
                           dtype=torch.int32)
        clean = int((want[-1].cpu() == hdr).sum())
        if not 0 < clean < len(states):
            raise AssertionError(f"dsd edge lanes {profile}: {clean} clean "
                                 f"lanes of {len(states)}")
        wide = _wide_lanes(kernel)
        if wide is not None:
            from wvpk_torch.ops.dsd_cuda import int64_lanes

            expect = int(int64_lanes(args[2], args[3], g.prof.mono).sum())
            if wide != expect or not wide:
                raise AssertionError(f"dsd edge lanes {profile}: {wide} "
                                     f"int64-body lanes, {expect} staged")
        res.update(lanes=len(states), nsteps=g.nsteps, clean_lanes=clean,
                   payload_cap=int(g.data.shape[1]), int64_lanes=wide)
        results[profile] = res
    print(json.dumps({"phase": "dsd_edge_lanes_vs_plain_on_cpu",
                      "results": results}))


def check_dsd(states, files):
    """0 CRC errors, 0 mutes, every file byte-exact against its source
    bytes and the scalar oracle agreeing on probe blocks. `files` is
    [(block count, source (n, ch))] in corpus order."""
    def check(results):
        info = _flags(results)
        pos = 0
        for k, (nblk, src) in enumerate(files):
            got = np.concatenate([r.samples for r in results[pos:pos + nblk]])
            if not np.array_equal(got, src):
                raise AssertionError(f"DSD file {k} is not byte-exact")
            pos += nblk
        info["byte_exact"] = True
        info["oracle_blocks"] = _probe(results, states, [files[0][0]])
        return info
    return check


def dsd_stage_breakdown(states, device):
    """One DSD decode split into its stages, each closed by a
    synchronize: seconds per stage."""
    from wvpk_torch.engine import dsd_pipeline as dp
    from wvpk_torch.engine.pipeline import _fetch_arrays

    marks = {}
    t0 = time.perf_counter()

    def mark(name):
        nonlocal t0
        torch.cuda.synchronize()
        now = time.perf_counter()
        marks[name] = marks.get(name, 0.0) + now - t0
        t0 = now

    groups = dp.group_dsd(states)
    mark("staging")
    staged = [dp.group_tensors(g, device) for g in groups]
    mark("h2d")
    decoded = dp.decode_groups(groups, staged)
    mark("decode_kernels")
    launched = [dp.deliver_group(g, *r) for g, r in zip(groups, decoded)]
    mark("deliver")
    fetched = _fetch_arrays(dp.fetch_list(launched))
    mark("d2h")
    dp.finalize_dsd_groups(launched, fetched)
    mark("finalize")
    return marks


def phase_dsd(dev, pool, jobs, lossless):
    """Phase 7. `jobs` from submit_dsd; `lossless` the (files, pcms) of
    the lossless corpus, whose first 16 files join the mixed call.
    Returns ({kernel row: a callable that checks the kernel against its
    plain version, run in `pool`, and returns its results}, launches, a
    mode-3 file and its source for the CLI)."""
    from wvpk_torch.container import parse_blocks

    t0 = time.perf_counter()
    groups, files, states = {}, [], []
    for name, futs in jobs.items():
        sts = []
        for f in futs:
            wv, src = f.result()
            blocks = [b.state for b in parse_blocks(wv)]
            files.append((len(blocks), src))
            sts += blocks
        groups[name] = sts
        states += sts
    vals = sum(src.size for _n, src in files)
    print(json.dumps({
        "phase": "dsd_corpus", "files": len(files), "blocks": len(states),
        "lanes_per_group": {k: len(v) for k, v in groups.items()},
        "byte_values": vals, "seconds_of_dsd64_stereo":
            vals / DSD64_STEREO_BYTEVALS_PER_S,
        "bytes": sum(len(f.result()[0]) for v in jobs.values() for f in v),
        "seconds": time.perf_counter() - t0}))

    # the kernels against their plain versions: the plain decodes run in
    # the worker pool while the card goes on, and are checked at the end
    checks = {name: compare_dsd(name, groups[name], dev, pool)
              for name in [g[0] for g in DSD_GROUPS + DSD_EXTRA[:2]]}

    launches = decode_phase(
        "dsd", states, vals, dev, ("dsd_fast", "dsd_high"),
        check_dsd(states, files), rate_key="mbytevals_per_s",
        realtime=DSD64_STEREO_BYTEVALS_PER_S)
    # a call: one launch per mode-1 group (bins 4, bins 32, mono) and per
    # mode-3 group (stereo, mono); four calls
    if (launches["dsd_fast"], launches["dsd_high"]) != (3 * 4, 2 * 4):
        raise AssertionError(f"dsd: launches a call differ: {launches}")
    print(json.dumps({"phase": "dsd_groups_side_streams_vs_sequence",
                      **dsd_side_vs_sequence(states, dev)}))

    # one call mixing 16 lossless files with the DSD corpus
    from wvpk_torch.engine import decode_states

    l_files, l_pcms = lossless
    l_states, l_per_file = parse_corpus(l_files, 16)
    counters = _counters()
    _reset(counters)
    t1 = time.perf_counter()
    results = decode_states(l_states + states, dev)
    torch.cuda.synchronize()
    mixed_s = time.perf_counter() - t1
    mixed = {k: fn.launches for k, fn in counters.items()}
    if min(mixed[k] for k in ("entropy", "decorr", "dsd_fast",
                              "dsd_high")) < 1:
        raise AssertionError(f"mixed call skipped a kernel: {mixed}")
    check_exact(l_states, l_per_file, l_pcms, probe=False)(
        results[:len(l_states)])
    info = check_dsd(states, files)(results[len(l_states):])
    print(json.dumps({"phase": "dsd_mixed_with_lossless",
                      "blocks": len(results), "seconds": mixed_s,
                      "launches": mixed, **info}))
    print(json.dumps({"phase": "dsd_stage_seconds",
                      "stages": dsd_stage_breakdown(states, dev)}))
    wv, src = jobs["dsd_high"][0].result()
    return checks, launches, (wv, src), states


def track_head(frames=None):
    """The encode corpus: the lossless corpus' 192 source arrays (file k
    is signal k % 16) one after another, a 768 s 16-bit stereo track; with
    `frames`, only its first `frames` frames."""
    pcms = corpus_pcms()
    n = len(pcms[0])
    count = N_FILES if frames is None else -(-frames // n)
    return np.concatenate([pcms[k % N_DISTINCT] for k in range(count)])[
        :frames]


def small_file(name):
    """A small file of the encode phase, whose CUDA and CPU encodes must be
    byte-identical: (pcm, encode_device options, WAV (bits, bytes per
    sample, format tag))."""
    n = int(44100 * ENC_SMALL_SECONDS)
    if name == "track_slice":
        return track_head(ENC_SLICE_BLOCKS * ENC_BLOCK), {}, (16, 2, 1)
    if name == "mono":
        return _tone_pair(1500, 330, 9000, 600, 1.0, 32768, n)[:, :1], {}, \
            (16, 2, 1)
    if name == "float":
        pcm = _tone_pair(1501, 410, 12000, 900, 0.7, 32768, n) / 32768.0
        return pcm.astype(np.float32), {}, (32, 4, 3)
    if name == "int32_wvx":
        pcm = _tone_pair(1502, 520, 9000, 600, 0.8, 32768, n) << 14 | 1
        return pcm, {"bytes_per_sample": 4}, (32, 4, 1)
    # 5.1 at 24 bits: three stereo pairs of tones
    pcm = np.concatenate([_tone_pair(1503 + k, 200 + 130 * k, 2 ** 21,
                                     2 ** 15, 0.6 + 0.1 * k, 1 << 23, n)
                          for k in range(3)], axis=1)
    return pcm, {"bytes_per_sample": 3}, (24, 3, 1)


def cpu_encode(name):
    """A small file's encode_device on the CPU (the plain versions). Runs
    in a worker process."""
    from wvpk_torch.encode import encode_device

    torch.set_num_threads(1)
    pcm, kw, _fmt = small_file(name)
    return encode_device(pcm, device="cpu", block_samples=ENC_BLOCK,
                         warmup=ENC_WARMUP, **kw)


def plain_encode_kernel(kind, arrays, kw):
    """A plain encode kernel on the CPU copy of a launch's inputs (numpy
    arrays); returns its outputs as numpy arrays and its time (ms, host
    clock). Runs in a worker process."""
    from wvpk_torch.ops.encode_cuda import hybrid_encode_plain
    from wvpk_torch.ops.encode_kernels import decorr_invert_warm

    torch.set_num_threads(1)
    fn = {"invert": decorr_invert_warm, "hybrid": hybrid_encode_plain}[kind]
    t0 = time.perf_counter()
    out = _flat(fn)(*(torch.from_numpy(a) for a in arrays), **kw)
    return [o.numpy() for o in out], 1000 * (time.perf_counter() - t0)


def _flat(fn):
    """`fn` with its outputs as one flat tuple (the invert's final state
    comes as a nested tuple)."""
    def run(*args, **kw):
        out = fn(*args, **kw)
        if not isinstance(out, tuple):
            return (out,)
        if len(out) == 2 and isinstance(out[1], tuple):
            return (out[0],) + out[1]
        return out
    return run


def _enc_kernels():
    from wvpk_torch.ops import encode_cuda, encode_kernels

    return {"invert": (encode_cuda.decorr_invert_cuda,
                       encode_kernels.decorr_invert_warm),
            "words": (encode_cuda.encode_words_cuda,
                      encode_cuda.encode_words_plain),
            "hybrid": (encode_cuda.hybrid_encode_cuda,
                       encode_cuda.hybrid_encode_plain)}


def _enc_launches(lanes, kind, warm=False, seeded=False):
    """A kernel launch of the encoder's main path on `lanes` (a staged
    batch, device_encoder.stage_lanes): (args, keywords, need, out_need),
    the last two the bytes the function must move (check_pair): what the
    lanes hold (each lane's samples, the chain slots it runs), int32
    samples and residuals at 4 bytes, the payload at its bytes. `warm`:
    the invert's warm launch (the first ENC_WARMUP steps, the final state
    returned) from zero seeds, or with `seeded` from the staged seeds."""
    t = lanes.t
    L = len(lanes.starts)
    C = 1 if lanes.mono else 2
    nt = int(t["num_terms"].to(torch.int64).sum())
    chain = {1: 4 * nt, 2: 4 * nt, 3: 4 * L, 4: 4 * nt,
             5: 0 if lanes.mono else 4 * nt, 6: 32 * nt,
             7: 0 if lanes.mono else 32 * nt}
    values = int(lanes.nsamp.sum()) * C
    # every lane carries the spec's chain, as the encoder passes it
    static = tuple(lanes.spec.terms)
    if kind == "invert":
        if warm:
            K = min(ENC_WARMUP, t["targets"].shape[0])
            z16 = torch.zeros_like(t["w0a"])
            z168 = torch.zeros_like(t["h0a"])
            seeds = ((t["w0a"], t["w0b"], t["h0a"], t["h0b"]) if seeded
                     else (z16, z16, z168, z168))
            args = (t["targets"][:K].contiguous(), t["terms"], t["deltas"],
                    t["num_terms"], *seeds)
            wvals = int(np.minimum(lanes.nsamp, K).sum()) * C
            state = {1: 4 * nt, 2: chain[5], 3: 32 * nt, 4: chain[7]}
            return args, dict(mono=lanes.mono, with_state=True,
                              static_terms=static), \
                {0: 4 * wvals, **chain}, {0: 4 * wvals, **state}
        args = (t["targets"], t["terms"], t["deltas"], t["num_terms"],
                t["w0a"], t["w0b"], t["h0a"], t["h0b"])
        return args, dict(mono=lanes.mono, static_terms=static), \
            {0: 4 * values, **chain}, {0: 4 * values}
    if kind == "words":
        res = t["residuals"]
        T = res.shape[0]
        args = (res.permute(0, 2, 1).reshape(T * C, L).contiguous(),
                t["med0"], t["nvals"])
        return args, dict(mono=lanes.mono), \
            {0: 4 * values, 1: 24 * C * L, 2: 4 * L}, {}
    args = (t["targets"], t["terms"], t["deltas"], t["num_terms"],
            t["med0"], t["slow0"], t["acc0"], t["delta0"], t["nvals"],
            t["w0a"], t["w0b"], t["h0a"], t["h0b"])
    need = {0: 4 * values, 1: chain[1], 2: chain[2], 3: chain[3],
            4: 24 * C * L, 5: 8 * C * L, 6: 8 * C * L, 7: 8 * C * L,
            8: 4 * L, 9: chain[4], 10: chain[5], 11: chain[6],
            12: chain[7]}
    return args, dict(lanes.kw, static_terms=static), need, \
        {2: 4 * values}


def _payload_need(out_need, got):
    """out_need with the payload (output 0) at its bytes and the bit
    totals (output 1) at 8 bytes a lane."""
    total = got[1].to(torch.int64)
    return {**out_need, 0: int(((total + 7) // 8).sum()),
            1: 8 * total.numel()}


def _lane_prefix(args, n):
    """The first `n` lanes of an encode launch's arguments: the lane axis
    is 1 for the first ((T, L, C) samples or (W, L) words), else 0."""
    return tuple((a[:, :n] if k == 0 else a[:n]).contiguous()
                 for k, a in enumerate(args))


def compare_encode(name, kind, lanes, dev, warm=False):
    """An encode kernel at the main path's launch (all the track's lanes)
    against its plain version on the card, timed, then launched on its
    first 64 lanes, timed and held against the plain outputs of those
    lanes; the invert and the hybrid kernel also through their run-time
    kernel on all the lanes. Each launch must run the kernel the main
    path runs (the default chain's, with the final state for the warm
    invert) or the run-time one. Returns (the kernel's outputs,
    {max_abs_err, ms, plain_ms, bytes, bound_ms, ...})."""
    from wvpk_torch.ops.encode_cuda import invert_instance

    kernel, plain = _enc_kernels()[kind]

    def expect(ran, instance):
        if kind == "invert":
            instance = invert_instance(instance, warm)
        if ran != {instance: 1}:
            raise AssertionError(f"encode {name}: ran {ran}, expected the "
                                 f"{instance} kernel")
        return ran

    args, kw, need, out_need = _enc_launches(lanes, kind, warm)
    if kind != "invert":
        out_need = _payload_need(out_need, kernel(*args, **kw))
    got, want, res = check_pair(name, _flat(kernel), _flat(plain), args, kw,
                                True, need=need, out_need=out_need)
    if kind != "invert":
        res["int64_lanes"] = int(kernel.wide_lanes)
    if kind != "words":
        res["instances"] = expect(_chain_instances(kernel, args, kw),
                                  "default")
    args64 = _lane_prefix(args, 64)
    got64 = _flat(kernel)(*args64, **kw)
    _sync()
    res.update(lanes=len(lanes.starts), steps=int(args[0].shape[0]),
               slice_lanes=64, slice_max_abs_err=check_prefix(
                   name, want, got64),
               slice_ms=_events_ms(lambda: kernel(*args64, **kw), 5))
    if kind != "words":
        # the run-time kernel (no static_terms) on the same lanes, held
        # against the same plain outputs (the final state too) and timed
        gkw = dict(kw, static_terms=None)
        ggot = _flat(kernel)(*args, **gkw)
        _sync()
        generic = {"instances": expect(_chain_instances(kernel, args, gkw),
                                       "generic"),
                   "max_abs_err": check_prefix(name + "[generic]", want,
                                               ggot),
                   "ms": _events_ms(lambda: kernel(*args, **gkw), 5),
                   "plain_ms": res["plain_ms"], "bytes": res["bytes"],
                   "bound_ms": res["bound_ms"]}
        if kind == "hybrid":
            generic["int64_lanes"] = int(kernel.wide_lanes)
        res["generic"] = generic
    print(json.dumps({"phase": f"encode_{name}_kernel_vs_plain", **res}))
    return got, res


def _chain_instances(kernel, args, kw) -> dict:
    """The kernel instantiations (chain kernels or the run-time one) one
    launch of the invert or the hybrid kernel on `args` runs, by the
    wrapper's per-instance counts."""
    before = dict(kernel.chain_launches)
    kernel(*args, **kw)
    _sync()
    return {k: v - before[k] for k, v in kernel.chain_launches.items()
            if v != before[k]}


def stage_variant(pcm, dev, **options):
    """stage_lanes of `pcm` for a variant launch (64 lanes), with the
    spec's HYBRID_BITRATE / HYBRID_BALANCE overridden where given."""
    from dataclasses import replace

    from wvpk_torch.encode import build_spec
    from wvpk_torch.engine.device_encoder import stage_lanes

    flags = {k: options.pop(k) for k in ("hybrid_bitrate", "hybrid_balance")
             if k in options}
    spec = replace(build_spec(pcm, block_samples=ENC_BLOCK, **options),
                   **flags)
    return stage_lanes(pcm, spec, ENC_WARMUP, dev)


def _set_chain(lanes, chain):
    """Every lane of `lanes` on `chain` (in its first len(chain) slots):
    the staged deltas and seeds stay, so the slots past a chain shorter
    than the spec's hold seeds the final state must keep."""
    t = lanes.t
    t["terms"] = torch.zeros_like(t["terms"])
    t["terms"][:, :len(chain)] = torch.tensor(
        chain, dtype=t["terms"].dtype, device=t["terms"].device)
    t["num_terms"] = torch.full_like(t["num_terms"], len(chain))


# the invert's variant launches: (name, pcm, options, chain, kernel): the
# spec's chain ("spec"), a chain of CHAINS with no preset, or one outside
# (the mono chain with cross terms), each given as static_terms; None runs
# the launch with static_terms=None (the run-time kernel, on the high
# preset's stereo cross terms too). Each also runs as "<name>_state": the
# first ENC_WARMUP steps from the staged seeds, with the final state.
BENCH = (18, 17, 2)
CROSS_MONO = (18, -1, 17, -2, 3)
INVERT_VARIANTS = (
    ("default", "head", {}, "spec", "default"),
    ("fast", "head", dict(preset="fast"), "spec", "fast"),
    ("high", "head", dict(preset="high"), "spec", "high"),
    ("bench", "head", {}, BENCH, "bench"),
    ("default_mono", "mono", {}, "spec", "default_mono"),
    ("fast_mono", "mono", dict(preset="fast"), "spec", "fast_mono"),
    ("high_mono", "mono", dict(preset="high"), "spec", "high_mono"),
    ("bench_mono", "mono", {}, BENCH, "bench_mono"),
    ("generic", "head", {}, None, "generic"),
    ("generic_high", "head", dict(preset="high"), None, "generic"),
    ("generic_mono", "mono", {}, None, "generic_mono"),
    ("cross_mono", "mono", {}, CROSS_MONO, "generic_mono"))


def submit_variants(pool, dev):
    """The encode kernels' other instantiations on 64 lanes: each launched
    on the card (timed) and its plain version queued on the worker pool
    on a CPU copy of the same inputs. Returns [(name, kernel outputs,
    ms, info, future)]."""
    from wvpk_torch.ops import encode_cuda as ec

    head = track_head(ENC_SLICE_BLOCKS * ENC_BLOCK)
    mono = small_file("mono")[0][:ENC_SLICE_BLOCKS * ENC_BLOCK]
    kernels = _enc_kernels()
    jobs = []
    # each variant with the kernel it must run: its preset's chain
    # (ops/decorr_cuda.py::CHAINS), or the run-time kernel when the launch
    # names no chain
    hyb = dict(hybrid=True, bitrate=ENC_BITRATE)
    pcms = {"head": head, "mono": mono}
    inverts = [(f"invert_{name}{'_state' if state else ''}", "invert",
                pcms[pcm], dict(options, chain=chain, state=state), runs)
               for state in (False, True)
               for name, pcm, options, chain, runs in INVERT_VARIANTS]
    for name, kind, pcm, options, runs in [
            ("hybrid_balance", "hybrid", head,
             dict(hyb, hybrid_balance=True), "default"),
            ("hybrid_no_bitrate", "hybrid", head,
             dict(hyb, hybrid_bitrate=False), "default"),
            ("hybrid_mono", "hybrid", mono, hyb, "default_mono"),
            ("hybrid_fast", "hybrid", head, dict(hyb, preset="fast"),
             "fast"),
            ("hybrid_high", "hybrid", head, dict(hyb, preset="high"),
             "high"),
            ("hybrid_fast_mono", "hybrid", mono, dict(hyb, preset="fast"),
             "fast_mono"),
            ("hybrid_high_mono", "hybrid", mono, dict(hyb, preset="high"),
             "high_mono"),
            ("hybrid_generic", "hybrid", head, hyb, "generic")] + inverts:
        chain = options.pop("chain", "spec")
        state = options.pop("state", False)
        if kind == "hybrid" and runs == "generic":
            chain = None
        lanes = stage_variant(pcm, dev, **options)
        if chain not in ("spec", None):
            _set_chain(lanes, chain)
        args, kw, need, out_need = _enc_launches(lanes, kind, warm=state,
                                                 seeded=True)
        if chain != "spec":
            kw = dict(kw, static_terms=chain)
        got = _flat(kernels[kind][0])(*args, **kw)
        _sync()
        if kind != "invert":
            out_need = _payload_need(out_need, kernels[kind][0](*args, **kw))
        if kind == "invert":
            runs = ec.invert_instance(runs, state)
        info = {"instances": _chain_instances(kernels[kind][0], args, kw)}
        if info["instances"] != {runs: 1}:
            raise AssertionError(f"encode {name}: ran {info['instances']}, "
                                 f"expected the {runs} kernel")
        nbytes = _moved_bytes(args, got, need, out_need)
        ms = _events_ms(lambda: kernels[kind][0](*args, **kw), 5)
        arrays = [a.cpu().numpy() for a in args]
        jobs.append((name, got, ms, dict(
            lanes=len(lanes.starts), profile=kw, bytes=nbytes,
            bound_ms=1000 * nbytes / HBM_BYTES_PER_S, **info),
                     pool.submit(plain_encode_kernel, kind, arrays, kw)))
    return jobs


def check_variants(jobs):
    """Each variant launch against its plain version's outputs."""
    out = {}
    for name, got, ms, info, fut in jobs:
        t0 = time.perf_counter()
        want, plain_ms = fut.result()
        want = [torch.from_numpy(w) for w in want]
        for k, (w, g) in enumerate(zip(want, got)):
            if not torch.equal(w, g.cpu()):
                raise AssertionError(f"encode {name}: kernel != plain "
                                     f"version, output {k}")
        out[name] = {**info, "ms": ms, "plain_ms": plain_ms,
                     "plain_device": "cpu", "max_abs_err": max(
                         _max_abs_err(w, g.cpu()) for w, g in zip(want, got)),
                     "waited_s": time.perf_counter() - t0}
    print(json.dumps({"phase": "encode_variants_64_lanes_vs_plain_on_cpu",
                      "results": out}))
    return out


# the encode edge lanes (testgen/edge.py::encode_edge_lanes): each kind
# with the coder's profiles, HYBRID_BALANCE on stereo only
ENC_EDGE_CASES = (("words", None), ("words_mono", None),
                  ("hybrid", (False, False)), ("hybrid", (True, False)),
                  ("hybrid", (True, True)), ("hybrid_mono", (False, False)),
                  ("hybrid_mono", (True, False)))
ENC_EDGE_SEED = 17
INVERT_EDGE_KINDS = ("hybrid", "hybrid_mono")


def _edge_kw(kind, flags):
    kw = dict(mono=kind.endswith("_mono"))
    if flags is not None:
        kw.update(hybrid_bitrate=flags[0], hybrid_balance=flags[1])
    return kw


def plain_encode_edge(kind, flags):
    """A word coder's plain version on the encode edge lanes of `kind`;
    its outputs as numpy arrays. Runs in a worker process."""
    from wvpk_torch.ops.encode_cuda import encode_words_plain, \
        hybrid_encode_plain
    from wvpk_torch.testgen.edge import encode_edge_lanes

    torch.set_num_threads(1)
    args = [torch.from_numpy(a)
            for a in encode_edge_lanes(kind, EDGE_LANES, ENC_EDGE_SEED)]
    fn = encode_words_plain if flags is None else hybrid_encode_plain
    return [o.numpy() for o in fn(*args, **_edge_kw(kind, flags))]


def plain_invert_edge(kind):
    """The invert's plain version on the encode edge lanes of `kind` (a
    hybrid kind: their targets, chains and seeds), with the final state;
    its outputs as numpy arrays. Runs in a worker process."""
    from wvpk_torch.ops.encode_kernels import decorr_invert_warm
    from wvpk_torch.testgen.edge import encode_edge_lanes

    torch.set_num_threads(1)
    a = [torch.from_numpy(x)
         for x in encode_edge_lanes(kind, EDGE_LANES, ENC_EDGE_SEED)]
    out = _flat(decorr_invert_warm)(*a[:4], *a[9:], with_state=True,
                                     mono=kind.endswith("_mono"))
    return [o.numpy() for o in out]


def invert_edges(dev, jobs):
    """The hybrid edge lanes' targets, chains and seeds through the
    invert, with and without the final state, by the chain's kernel
    (static_terms) and the run-time kernel, against the plain version,
    which ran in the worker pool."""
    from wvpk_torch.ops.encode_cuda import decorr_invert_cuda as inv
    from wvpk_torch.ops.encode_cuda import invert_instance
    from wvpk_torch.testgen.edge import ENCODE_EDGE_CHAIN, encode_edge_lanes

    out = {}
    for kind in INVERT_EDGE_KINDS:
        mono = kind.endswith("_mono")
        a = [torch.from_numpy(x).to(dev)
             for x in encode_edge_lanes(kind, EDGE_LANES, ENC_EDGE_SEED)]
        want = [torch.from_numpy(w) for w in jobs[("invert", kind)].result()]
        rows = []
        for with_state in (False, True):
            for st, runs in ((ENCODE_EDGE_CHAIN,
                              "default_mono" if mono else "default"),
                             (None, "generic_mono" if mono else "generic")):
                kw = dict(mono=mono, with_state=with_state, static_terms=st)
                runs = invert_instance(runs, with_state)
                before = dict(inv.chain_launches)
                got = _flat(inv)(*a[:4], *a[9:], **kw)
                _sync()
                ran = {k: v - before[k] for k, v in inv.chain_launches.items()
                       if v != before[k]}
                if ran != {runs: 1}:
                    raise AssertionError(f"invert edge {kind}: ran {ran}, "
                                         f"expected the {runs} kernel")
                for k, (w, g) in enumerate(zip(want, got)):
                    if not torch.equal(w, g.cpu()):
                        raise AssertionError(
                            f"invert edge {kind} ({ran}, with_state="
                            f"{with_state}): kernel != plain, output {k}")
                rows.append({"with_state": with_state, "instances": ran,
                             "outputs": len(got), "max_abs_err": max(
                                 _max_abs_err(w, g.cpu())
                                 for w, g in zip(want, got))})
        out[kind] = rows
    return out


def phase_encode_edges(dev, jobs):
    """Each word coder on the 64 encode edge lanes of each kind and
    profile, held against its plain version, which ran in the worker pool;
    the hybrid lanes through their chain's kernel and the run-time kernel.
    The int64 body must run exactly the lanes int64_lanes names. Then the
    hybrid lanes' chain arguments through the invert (invert_edges)."""
    from wvpk_torch.ops import encode_cuda as ec
    from wvpk_torch.testgen.edge import ENCODE_EDGE_CHAIN, encode_edge_lanes

    out = {}
    for kind, flags in ENC_EDGE_CASES:
        args = [torch.from_numpy(a).to(dev)
                for a in encode_edge_lanes(kind, EDGE_LANES, ENC_EDGE_SEED)]
        kw = _edge_kw(kind, flags)
        if flags is None:
            fn, med0, runs = ec.encode_words_cuda, args[1], [kw]
        else:
            fn, med0 = ec.hybrid_encode_cuda, args[4]
            runs = [dict(kw, static_terms=st)
                    for st in (ENCODE_EDGE_CHAIN, None)]
        got = []
        for rkw in runs:
            before = dict(getattr(fn, "chain_launches", {}))
            res = fn(*args, **rkw)
            _sync()
            ran = {k: v - before[k]
                   for k, v in getattr(fn, "chain_launches", {}).items()
                   if v != before[k]}
            wide = int(fn.wide_lanes)
            if wide != int(ec.int64_lanes(med0).sum()) or wide == 0:
                raise AssertionError(f"encode edge {kind}: {wide} lanes in "
                                     f"the int64 body")
            got.append((ran, res, wide))
        want = [torch.from_numpy(w) for w in jobs[(kind, flags)].result()]
        name = kind + ("" if flags is None else
                       "_" + ("bitrate" if flags[0] else "plain")
                       + ("_balance" if flags[1] else ""))
        for ran, g, wide in got:
            for k, (w, x) in enumerate(zip(want, g)):
                if not torch.equal(w, x.cpu()):
                    raise AssertionError(f"encode edge {name} ({ran}): "
                                         f"kernel != plain, output {k}")
        out[name] = [{"instances": ran, "int64_lanes": wide,
                      "max_abs_err": max(_max_abs_err(w, x.cpu())
                                         for w, x in zip(want, g))}
                     for ran, g, wide in got]
    print(json.dumps({"phase": "encode_edge_lanes_vs_plain_on_cpu",
                      "lanes": EDGE_LANES, "results": out,
                      "invert": invert_edges(dev, jobs)}))


def _enc_counts(reset=False):
    """The encode wrappers' launch counts, the invert kernel's split into
    its main and its warm (with_state) launches, and the invert and
    hybrid kernels' by instantiation ("encode_invert:<chain>"); with
    `reset` all set to 0 first."""
    from wvpk_torch.ops import encode_cuda as ec

    inv, hyb = ec.decorr_invert_cuda, ec.hybrid_encode_cuda
    if reset:
        inv.launches = inv.warm_launches = 0
        ec.encode_words_cuda.launches = hyb.launches = 0
        for fn in (inv, hyb):
            fn.chain_launches = dict.fromkeys(fn.chain_launches, 0)
    return {"encode_invert": inv.launches - inv.warm_launches,
            "encode_invert[warm]": inv.warm_launches,
            "encode_words": ec.encode_words_cuda.launches,
            "encode_hybrid": hyb.launches,
            **{f"{key}:{k}": n
               for key, fn in (("encode_invert", inv), ("encode_hybrid", hyb))
               for k, n in fn.chain_launches.items() if n}}


def encode_e2e(name, track, dev, per_call, **options):
    """encode_device on the whole track: every launch count set to 0, one
    warm-up and two timed calls, the counts read (each kernel must have
    launched exactly `per_call` times a call), the last call split into
    its trace stages (enc_scan is the host's launch time; the kernels'
    device time lands in enc_fetch, the first synchronising copy).
    Returns (the .wv bytes, the phase line's fields)."""
    from wvpk_torch import trace
    from wvpk_torch.encode import encode_device

    _enc_counts(reset=True)
    rates = []
    wv = None
    for rep in range(ENC_CALLS):
        wv = None
        with trace.collect() as stages:
            t0 = time.perf_counter()
            wv = encode_device(track, device=dev, block_samples=ENC_BLOCK,
                               warmup=ENC_WARMUP, **options)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if rep > 0:
            rates.append(len(track) / dt / 1e6)
    launches = _enc_counts()
    want = {k: ENC_CALLS * per_call.get(k, 0)
            for k in {*launches, *per_call}}
    if {k: launches.get(k, 0) for k in want} != want:
        raise AssertionError(f"encode {name}: launches {launches} over "
                             f"{ENC_CALLS} calls, expected {want}")
    return wv, {"msamples_per_s": rates, "warmup": 1, "frames": len(track),
                "bytes": len(wv), "ratio": len(wv) / track.nbytes * 4,
                "launches": launches,
                "launches_per_call": {k: v / ENC_CALLS
                                      for k, v in launches.items()},
                "last_call_stage_seconds": stages.seconds(),
                "last_call_s": dt}


def profile_encode(track, dev):
    """One more lossless encode_device call under torch.profiler: the
    device's busy time (the union of the intervals of its kernels and
    copies in the trace) over the call's wall time gives the device's
    idle share; the busiest device activities beside it. A trace without
    device events leaves the share "not measured" (null)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wvpk_torch.encode import encode_device

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        encode_device(track, device=dev, block_samples=ENC_BLOCK,
                      warmup=ENC_WARMUP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:             # the union of the intervals
        if e > end:
            busy_us += e - max(s, end)
            end = e
    top = sorted(((a.key, a.count, a.self_device_time_total / 1e3)
                  for a in prof.key_averages()
                  if a.self_device_time_total > 0),
                 key=lambda r: -r[2])[:8]
    return {"wall_s": wall, "device_events": len(spans),
            "device_busy_s": busy_us / 1e6 if spans else None,
            "device_idle_share": 1 - busy_us / 1e6 / wall if spans else None,
            "top_device_ms": [{"name": k[:80], "count": n, "ms": ms}
                              for k, n, ms in top]}


def check_encoded(wv, dev, pcm=None):
    """The port's decode_states of an encoded stream on the card: 0 CRC
    errors, 0 mutes; with `pcm` sample-exact and the stored MD5 equal to
    the source's, else the scalar oracle agreeing on probe blocks."""
    import hashlib

    from wvpk_torch.container import parse_blocks
    from wvpk_torch.engine import decode_states
    from wvpk_torch.io.pcm import format_samples

    blocks = parse_blocks(wv)
    states = [b.state for b in blocks]
    t0 = time.perf_counter()
    results = decode_states(states, dev)
    torch.cuda.synchronize()
    info = {"blocks": len(states), "decode_s": time.perf_counter() - t0,
            **_flags(results)}
    if pcm is None:
        info["oracle_blocks"] = _probe(results, states, [len(states)])
        return info
    got = np.concatenate([r.samples for r in results])
    if not np.array_equal(got, pcm):
        raise AssertionError("the encoded track does not decode "
                             "sample-exact")
    stored = [b.updates.md5 for b in blocks if b.updates.md5 is not None]
    if stored != [hashlib.md5(format_samples(pcm, 2)).digest()]:
        raise AssertionError("the stored MD5 differs from the source's")
    info.update(sample_exact=True, md5_matches=True)
    return info


def phase_encode(dev, pool, cpu_jobs):
    """Phase 8: the device encoder on the card. Returns ({kernel row:
    results}, {kernel row: launches in the main path's runs}): the main
    invert and the words kernel in the lossless run, the hybrid kernel in
    the hybrid run, the warm invert in both."""
    from wvpk_torch.encode import build_spec
    from wvpk_torch.engine.device_encoder import stage_lanes

    t0 = time.perf_counter()
    track = track_head()
    print(json.dumps({"phase": "encode_corpus", "frames": len(track),
                      "blocks": -(-len(track) // ENC_BLOCK),
                      "seconds": time.perf_counter() - t0}))
    variants = submit_variants(pool, dev)

    # the kernels at the main path's launches, against their plain versions
    lanes = stage_lanes(track, build_spec(track, block_samples=ENC_BLOCK),
                        ENC_WARMUP, dev)
    _got, warm = compare_encode("invert_warm", "invert", lanes, dev, True)
    (lanes.t["residuals"],), main = compare_encode("invert", "invert",
                                                   lanes, dev)
    _got, words = compare_encode("words", "words", lanes, dev)
    lanes = stage_lanes(track, build_spec(track, block_samples=ENC_BLOCK,
                                          hybrid=True, bitrate=ENC_BITRATE),
                        ENC_WARMUP, dev)
    _got, hybrid = compare_encode("hybrid", "hybrid", lanes, dev)
    lanes = None
    variants = check_variants(variants)

    # both inverts of a lossless call and the warm one of a hybrid call run
    # the default chain's kernels (the warm one with the final state),
    # never a run-time one
    wv, info = encode_e2e("lossless", track, dev, {
        "encode_invert": 1, "encode_invert[warm]": 1,
        "encode_invert:default": 1, "encode_invert:default[state]": 1,
        "encode_words": 1})
    info.update(check_encoded(wv, dev, track))
    print(json.dumps({"phase": "encode_lossless_encode_device", **info}))
    l_launches = info["launches"]
    print(json.dumps({"phase": "encode_lossless_profiled_call",
                      **profile_encode(track, dev)}))
    wv, info = encode_e2e("hybrid", track, dev, {
        "encode_invert[warm]": 1, "encode_invert:default[state]": 1,
        "encode_hybrid": 1, "encode_hybrid:default": 1}, hybrid=True,
        bitrate=ENC_BITRATE)
    info.update(check_encoded(wv, dev))
    print(json.dumps({"phase": "encode_hybrid_encode_device", **info}))
    h_launches = info["launches"]
    wv = None

    from wvpk_torch.encode import encode_device

    small = {}
    for name, fut in cpu_jobs.items():
        pcm, kw, fmt = small_file(name)
        t1 = time.perf_counter()
        got = encode_device(pcm, device=dev, block_samples=ENC_BLOCK,
                            warmup=ENC_WARMUP, **kw)
        cuda_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        if fut.result() != got:
            raise AssertionError(f"{name}: the CUDA and CPU encodes differ")
        small[name] = {"frames": len(pcm), "channels": pcm.shape[1],
                       "bytes": len(got), "cuda_s": cuda_s,
                       "waited_cpu_s": time.perf_counter() - t1,
                       **check_encoded(got, dev)}
    print(json.dumps({"phase": "encode_small_files_cuda_equals_cpu",
                      "files": small}))
    rows = {"invert_warm": warm, "invert": main, "words": words,
            "hybrid": hybrid, "variants": variants}
    return rows, {k: l_launches.get(k, 0) + h_launches.get(k, 0)
                  for k in {*l_launches, *h_launches}}


def _small_wav(pcm, fmt):
    bits, nbytes, tag = fmt
    if tag == 3:
        body = pcm.astype("<f4").tobytes()
    else:
        from wvpk_torch.io.pcm import format_samples
        body = format_samples(pcm, nbytes)
    from wvpk_torch.io.wav import make_wav_header

    return make_wav_header(len(pcm), pcm.shape[1], 44100, bits, nbytes,
                           fmt_tag=tag) + body


def run_cli_encode(wavs, device):
    """`--encode` of several WAVs in one CLI process. `wavs` maps a name to
    the WAV bytes. Returns (seconds, {name: .wv bytes})."""
    work = os.path.join(REPO, "build", "chip_smoke", "encode")
    os.makedirs(work, exist_ok=True)
    paths = [os.path.join(work, name + ".wav") for name in wavs]
    for path, blob in zip(paths, wavs.values()):
        with open(path, "wb") as f:
            f.write(blob)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "wvpk_torch.cli", "--encode", *paths, "-q",
         "--device", str(device)], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"CLI exited {proc.returncode}: {proc.stderr}")
    out = {}
    for name, path in zip(wavs, paths):
        with open(path[:-4] + ".wv", "rb") as f:
            out[name] = f.read()
    return secs, out


# -- phase 10: lane sharding, chunked delivery, the sweep --------------------

CHUNK_BLOCKS = 512      # delivery_chunk_blocks of the chunked calls
DELIVERY_CALLS = 3      # timed calls a turn, after one warm-up
DELIVERY_TURNS = (0, CHUNK_BLOCKS, CHUNK_BLOCKS, 0) * 2
# bench.py:308-310's sweep: PCM, DSD, multichannel and wvc cases
SWEEP = dict(n_cases=40, n_dsd=8, n_mc=4, n_wvc=4)


def _same_results(want, got, name):
    """Two decodes' DecodedBlocks equal, samples and every flag."""
    if len(want) != len(got):
        raise AssertionError(f"{name}: {len(got)} blocks, {len(want)} "
                             "expected")
    for k, (w, g) in enumerate(zip(want, got)):
        if not (np.array_equal(w.samples, g.samples)
                and (w.crc, w.crc_x, w.crc_wvc, w.mute_error, w.crc_error,
                     w.wvc_applied) == (g.crc, g.crc_x, g.crc_wvc,
                                        g.mute_error, g.crc_error,
                                        g.wvc_applied)):
            raise AssertionError(f"{name}: block {k} differs")


def _shard_instances(states, mesh):
    """The decorrelation kernel instantiations each shard must launch in
    one sharded call: lane_runs on each shard's cut chain segments, per
    bucket. Returns [{"decorr[_wvc]:<instance>": launches}] a shard."""
    from wvpk_torch import consts
    from wvpk_torch.engine.staging import group_blocks
    from wvpk_torch.ops.decorr_cuda import instance_name, lane_runs
    from wvpk_torch.parallel import shard_bucket, shard_ranges

    per_shard = [{} for _ in mesh]
    for b in group_blocks([st for st in states if st.header.block_samples
                           and not st.flags & consts.DSD_FLAG]):
        key = "decorr_wvc" if b.profile.has_wvc else "decorr"
        for k, r in enumerate(shard_ranges(len(b.states), len(mesh))):
            if r is None:
                continue
            sub = shard_bucket(b, *r)
            for cid, _s, _e in lane_runs(r[1] - r[0], b.profile.mono,
                                         sub.static_terms,
                                         sub.chain_segments):
                name = f"{key}:{instance_name(cid, b.profile.mono)}"
                per_shard[k][name] = per_shard[k].get(name, 0) + 1
    return per_shard


def sharded_vs_unsharded(name, states, dev, mesh, table_chains=False):
    """sharded_decode_states over `mesh` against decode_states on `dev`:
    the same blocks, and the decorrelation instantiations launched those
    every shard's chain runs name (with `table_chains`, every shard runs
    a table chain's kernel). Returns the phase line's part."""
    from wvpk_torch.engine import decode_states
    from wvpk_torch.parallel import sharded_decode_states

    want = decode_states(states, dev)
    counters = _counters()
    _reset(counters)
    t0 = time.perf_counter()
    got = sharded_decode_states(states, mesh)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _same_results(want, got, f"sharded {name}")
    launched = _instances()
    per_shard = _shard_instances(states, mesh)
    expect = {}
    for shard in per_shard:
        for k, n in shard.items():
            expect[k] = expect.get(k, 0) + n
    if launched != expect:
        raise AssertionError(f"sharded {name}: decorrelation launches "
                             f"{launched}, the shards' runs name {expect}")
    if table_chains and not all(
            any(not k.endswith("generic") for k in shard)
            for shard in per_shard):
        raise AssertionError(f"sharded {name}: a shard ran no chain "
                             f"kernel: {per_shard}")
    return {"blocks": len(states), "equal": True, "seconds": dt,
            "launches": {k: fn.launches for k, fn in counters.items()
                         if fn.launches},
            "instances": launched, "instances_per_shard": per_shard}


def sharded_encode(dev, mesh):
    """encode_device over `mesh` on 64 blocks of the encode track,
    lossless and hybrid: the unsharded call's bytes, each kernel launched
    once a shard."""
    from wvpk_torch.encode import encode_device

    track = track_head(64 * ENC_BLOCK)
    out = {}
    for mode, opts in (("lossless", {}),
                       ("hybrid", {"hybrid": True, "bitrate": ENC_BITRATE})):
        kw = dict(block_samples=ENC_BLOCK, warmup=ENC_WARMUP, **opts)
        want = encode_device(track, device=dev, **kw)
        _enc_counts(reset=True)
        t0 = time.perf_counter()
        got = encode_device(track, mesh=mesh, **kw)
        dt = time.perf_counter() - t0
        launches = _enc_counts()
        if got != want:
            raise AssertionError(f"sharded encode {mode}: bytes differ")
        main = "encode_hybrid" if opts else "encode_words"
        if (launches[main], launches["encode_invert[warm]"]) \
                != (len(mesh), len(mesh)):
            raise AssertionError(f"sharded encode {mode}: launches "
                                 f"{launches} on {len(mesh)} shards")
        out[mode] = {"frames": len(track), "bytes": len(got),
                     "equal": True, "seconds": dt, "launches": launches}
    return out


def _digest(results) -> str:
    """One hash of a decode's blocks, samples and flags."""
    import hashlib

    h = hashlib.sha256()
    for r in results:
        h.update(np.ascontiguousarray(r.samples).tobytes())
        h.update(repr((r.samples.shape, r.crc, r.crc_x, r.crc_wvc,
                       r.mute_error, r.crc_error)).encode())
    return h.hexdigest()


def delivery_turns(states, frames, dev):
    """decode_states on the lossless corpus with delivery_chunk_blocks 0
    and CHUNK_BLOCKS, in DELIVERY_TURNS, each turn a warm-up and
    DELIVERY_CALLS timed calls: the rates, each stage's median over the
    timed calls (host clock, trace.collect), the transfer counts and
    launches of a call; every turn's blocks hash as the first call's (only
    the hash is kept: a caller holding a call's results while the next
    call allocates slows its finalize, decode_phase)."""
    from wvpk_torch import trace
    from wvpk_torch.config import set_options
    from wvpk_torch.engine import decode_states, pipeline

    res = {}
    ref = None
    splits = {}
    for ch in DELIVERY_TURNS:
        set_options(delivery_chunk_blocks=ch)
        try:
            r = res.setdefault(ch, {"msamples_per_s": []})
            counters = _counters()
            for rep in range(1 + DELIVERY_CALLS):
                results = None
                _reset(counters)
                with trace.collect() as stages:
                    t0 = time.perf_counter()
                    results = decode_states(states, dev)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                if rep:
                    r["msamples_per_s"].append(frames / dt / 1e6)
                    for k, v in stages.seconds().items():
                        splits.setdefault((ch, k), []).append(v)
                if rep == 1:
                    digest = _digest(results)
                    ref = ref or digest
                    if digest != ref:
                        raise AssertionError(f"delivery CH={ch}: blocks "
                                             "differ from the first call's")
                    r["equal"] = True
            r["transfer_bytes"] = {
                "h2d": stages.get("launch#h2d_bytes", 0),
                # copies made at the fetch, or queued ahead (chunked)
                "d2h": stages.get("transfer.copy#bytes", 0)
                + stages.get("transfer.enqueue#bytes", 0)}
            r["launches"] = {k: fn.launches for k, fn in counters.items()
                             if fn.launches}
            r["instances"] = _instances()
            r["chunks"] = len(pipeline._chunks(states))
        finally:
            set_options(delivery_chunk_blocks=0)
    for (ch, k), v in splits.items():
        res[ch].setdefault("stage_seconds_median", {})[k] = \
            float(np.median(v))
    if res[0]["instances"].keys() != res[CHUNK_BLOCKS]["instances"].keys():
        raise AssertionError("chunked delivery ran other kernels: "
                             f"{res[0]['instances']} / "
                             f"{res[CHUNK_BLOCKS]['instances']}")
    return {"single": res[0], "chunked": res[CHUNK_BLOCKS]}


def phase_sharding_delivery(dev, card, corpora):
    """Phase 10: the dry run on two entries of the card and the mesh of
    every visible GPU; sharded_decode_states against decode_states on the
    mixed-chain, wvc, wvx and DSD corpora; encode_device sharded, lossless
    and hybrid; the lossless corpus with chunked delivery against one
    fetch; the GPU differential sweep, unsharded and on two entries."""
    from wvpk_torch.parallel import make_mesh
    from wvpk_torch.parallel.dryrun import dryrun_multichip
    from wvpk_torch.testgen.fuzzspec import run_hw_sweep

    mesh = make_mesh(devices=[dev, dev])
    visible = make_mesh()
    t0 = time.perf_counter()
    counts = dryrun_multichip(mesh)
    print(json.dumps({"phase": "dryrun_multichip", "mesh": [str(d) for d in
                                                             mesh],
                      "blocks": counts, "seconds": time.perf_counter() - t0,
                      "visible_mesh": [str(d) for d in visible]}))
    sharded = {name: sharded_vs_unsharded(name, corpora[name], dev, mesh,
                                          table_chains=name == "mixed_chains")
               for name in ("mixed_chains", "wvc", "wvx", "dsd")}
    sharded["mixed_chains_visible_mesh"] = sharded_vs_unsharded(
        "mixed_chains", corpora["mixed_chains"], dev, visible)
    # each DSD wrapper reads the card once a launch (its limit check)
    sharded["dsd"]["host_reads"] = sum(
        sharded["dsd"]["launches"].get(k, 0) for k in ("dsd_fast",
                                                      "dsd_high"))
    print(json.dumps({"phase": "sharded_decode_states", "mesh": [
        str(d) for d in mesh], **sharded}))
    print(json.dumps({"phase": "sharded_encode_device",
                      **sharded_encode(dev, mesh)}))
    frames = corpora["lossless_frames"]
    print(json.dumps({"phase": "delivery_chunked_vs_single", "card": card,
                      "blocks": len(corpora["lossless"]), "frames": frames,
                      "chunk_blocks": CHUNK_BLOCKS,
                      "turns": DELIVERY_TURNS,
                      "timed_calls_a_turn": DELIVERY_CALLS,
                      **delivery_turns(corpora["lossless"], frames, dev)}))
    sweep = {}
    for name, m in (("unsharded", None), ("mesh2", mesh)):
        t1 = time.perf_counter()
        fails, blocks = run_hw_sweep(**SWEEP, device=dev, mesh=m)
        if fails:
            raise AssertionError(f"sweep {name}: {fails} mismatches")
        sweep[name] = {"fails": fails, "blocks": blocks,
                       "seconds": time.perf_counter() - t1}
    print(json.dumps({"phase": "hw_sweep", **SWEEP, **sweep}))


def _kernel_label(mangled: str) -> str:
    """A readable name for a kernel's mangled name: its function name and
    its template arguments (bools and ints), e.g.
    decorr_chain<false,false,18,17,2>."""
    import re

    m = re.search(
        r"\d+([a-z_]+(?:kernel|chain|generic|cluster)[a-z_]*)I(.*)E", mangled)
    if not m:
        return mangled
    args = []
    for kind, neg, v in re.findall(r"L([bi])(n?)(\d+)E", m.group(2)):
        args.append(("true" if v == "1" else "false") if kind == "b"
                    else ("-" if neg else "") + v)
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_table(log: str) -> list[dict]:
    """What `nvcc -Xptxas -v` said of each kernel of a source: its
    registers, stack frame and spill bytes."""
    import re

    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = {"kernel": _kernel_label(m.group(1))}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


# the registers (of a thread's 255) past which a build line names a kernel:
# a longer chain could spill
FLAG_REGISTERS = 224


def print_build(phase, names, seconds):
    """The build phase's line for the sources `names`: nvcc's seconds
    (from the start of the build) and what ptxas said of each kernel;
    every compiled decorrelation chain, both word coders, every hybrid
    and invert chain kernel (16 of the latter), both correction-scan
    kernels and both wvx kernels must have neither stack nor spills to be
    in registers (the run-time kernels keep their chains in local
    memory), or the run fails. The registers of the invert's, the
    correction scan's, the wvx and the decorrelation kernels' instances
    are listed by name, the very high chain's cluster kernels with their
    spills, and every kernel above FLAG_REGISTERS is named."""
    from wvpk_torch import _build

    ptxas = {k: ptxas_table(_build.ptxas_log[k]) for k in names
             if k in _build.ptxas_log}
    line = {"phase": phase, "seconds": seconds,
            "nvcc_seconds": {k: v for k, v in _build.build_seconds.items()
                             if k in names}}
    bad = []
    for key, src, prefixes, count in (
            ("decorr_chain", ("decorr",), ("decorr_chain", "decorr_cluster"),
             None),
            ("encode_coder", ("encode_words", "encode_hybrid"),
             ("words_kernel", "hybrid_chain"), None),
            ("invert_chain", ("encode_invert",), ("invert_chain",), 16),
            ("wvc", ("wvc",), ("wvc_kernel",), 2),
            ("wvx", ("wvx",), ("wvx_kernel",), 2)):
        if not any(k in ptxas for k in src):
            continue
        rows = [r for k in src for r in ptxas.get(k, [])
                if r["kernel"].startswith(prefixes)]
        line[f"{key}_kernels"] = len(rows)
        clean = all(r.get("stack") == 0 and r.get("spill_stores") == 0
                    and r.get("spill_loads") == 0 for r in rows)
        line[f"{key}s_without_stack_or_spills"] = clean
        if not clean or not rows or count not in (None, len(rows)):
            bad.append(key)
    for key, src in (("invert", "encode_invert"), ("wvc", "wvc"),
                     ("wvx", "wvx"), ("decorr", "decorr")):
        if src in ptxas:
            line[f"{key}_registers_stack"] = {
                r["kernel"]: [r.get("registers"), r.get("stack")]
                for r in ptxas[src]}
    if "decorr" in ptxas:
        line["decorr_cluster_registers_stack_spills"] = {
            r["kernel"]: [r.get("registers"), r.get("stack"),
                          r.get("spill_stores"), r.get("spill_loads")]
            for r in ptxas["decorr"]
            if r["kernel"].startswith("decorr_cluster")}
    line[f"kernels_above_{FLAG_REGISTERS}_registers"] = {
        r["kernel"]: r["registers"] for rows in ptxas.values() for r in rows
        if r.get("registers", 0) > FLAG_REGISTERS}
    line["ptxas"] = ptxas
    print(json.dumps(line))
    if bad:
        raise AssertionError(f"ptxas: a stack frame or spills, or a kernel "
                             f"missing, in {bad}")


def _wav(pcm, bits, nbytes, fmt_tag=1, body=None):
    from wvpk_torch.io.wav import make_wav_header

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
    import threading
    from concurrent.futures import ProcessPoolExecutor

    from wvpk_torch import _build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)

    # the encode sources with a kernel per chain build longest and the
    # encode phase is the first to need them: their nvcc runs beside the
    # decode phases and is joined before that phase
    late, late_errors = ("encode_hybrid", "encode_invert"), []

    def build_late():
        try:
            _build.build_all(late)
        except Exception as e:  # re-raised by the main thread at the join
            late_errors.append(e)

    late_build = threading.Thread(target=build_late)
    t0 = time.perf_counter()
    marks = {}    # seconds since the build started, at the end of each part

    def mark(name):
        marks[name] = time.perf_counter() - t0

    late_build.start()
    _build.build_all([n for n in _build.SOURCES if n not in late])
    print_build("build", [n for n in _build.SOURCES if n not in late],
                time.perf_counter() - t0)

    # the wvx and DSD files, the CPU encodes of the encode phase's small
    # files and its plain variant runs go to worker processes while the
    # card works
    with ProcessPoolExecutor(
            max_workers=POOL_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        from wvpk_torch.testgen.edge import EDGE_PROFILES, edge_states

        edge_jobs = {p: pool.submit(edge_states, p, EDGE_LANES, 11)
                     for p in EDGE_PROFILES}
        mixed_futures = [pool.submit(make_mixed, k)
                         for k in range(MIX_FILES * len(MIX_CHAINS))]
        wvx_futures = [pool.submit(make_wvx, i) for i in range(len(WVX_FILES))]
        dsd_jobs = submit_dsd(pool)
        from wvpk_torch.testgen.edge import DSD_EDGE_PROFILES, \
            dsd_edge_states

        dsd_edge_jobs = {p: pool.submit(dsd_edge_states, p, EDGE_LANES, 13)
                         for p in DSD_EDGE_PROFILES}
        cpu_encodes = {name: pool.submit(cpu_encode, name)
                       for name in ENC_SMALL}
        mark("start")
        lossless, l_launches, (l_files, l_pcms), l_states = \
            phase_lossless(dev)
        l_file, l_pcm = l_files[0], l_pcms[0]
        phase_entropy_edges(dev, edge_jobs)
        mark("lossless")
        mixed, m_launches, m_states = phase_mixed(dev, mixed_futures)
        mark("mixed")
        very_high, v_launches = phase_very_high(dev)
        mark("very_high")
        hybrid, h_launches = phase_hybrid(dev)
        wvc, c_launches, ((c_wv, c_wvc), c_pcm), c_states = phase_wvc(dev)
        phase_wvc_edges(dev)
        mark("hybrid_wvc")
        f_file, f_pcm, f_exp = phase_float(dev)
        wvx, x_launches, x_states = phase_wvx(dev, wvx_futures)
        mark("float_wvx")
        dsd_checks, d_launches, (d_wv, d_src), d_states = phase_dsd(
            dev, pool, dsd_jobs, (l_files, l_pcms))
        phase_dsd_edges(dev, dsd_edge_jobs)
        mark("dsd")
        late_build.join()
        if late_errors:
            raise late_errors[0]
        print_build("build_encode_chains", late, time.perf_counter() - t0)
        # the encode edge lanes' plain versions queue behind the decode
        # phases' work, which the card waits for
        enc_edge_jobs = {case: pool.submit(plain_encode_edge, *case)
                         for case in ENC_EDGE_CASES}
        enc_edge_jobs.update({("invert", kind): pool.submit(
            plain_invert_edge, kind) for kind in INVERT_EDGE_KINDS})
        enc, e_launches = phase_encode(dev, pool, cpu_encodes)
        mark("encode")
        phase_encode_edges(dev, enc_edge_jobs)
        # the DSD kernels against their plain versions, which ran in the
        # worker pool meanwhile
        dsd = {name: check() for name, check in dsd_checks.items()}
        mark("encode_edges_dsd_checks")

    from wvpk_torch.io.pcm import format_samples

    # --encode on the track and the small files' WAVs; their .wv files
    # decode in the next CLI call, with three decode-corpus files
    wavs = {"encoded_track": _small_wav(track_head(), (16, 2, 1))}
    for name in ENC_SMALL[1:]:
        pcm, _kw, fmt = small_file(name)
        wavs["encoded_" + name] = _small_wav(pcm, fmt)
    enc_s, encoded = run_cli_encode(wavs, dev)
    cli_s = run_cli({
        "lossless": (l_file, None, _wav(l_pcm, 16, 2)),
        "hybrid_wvc": (c_wv, c_wvc, _wav(c_pcm, 16, 2)),
        "float": (f_file, None, _wav(f_pcm, 32, 4, fmt_tag=3,
                                     body=format_samples(
                                         f_pcm, 4, float_norm_exp=f_exp))),
        **{name: (encoded[name], None, wav) for name, wav in wavs.items()}},
        dev)
    raw_s = run_cli({"dsd_high": (d_wv, None, d_src.tobytes())}, dev,
                    raw=True)
    mark("cli")
    phase_sharding_delivery(dev, card, {
        "lossless": l_states, "lossless_frames": _frames(l_pcms, N_FILES),
        "mixed_chains": m_states, "wvc": c_states, "wvx": x_states,
        "dsd": d_states})
    mark("sharding_delivery")
    print(json.dumps({"phase": "timeline", "seconds_since_start": marks}))
    print(json.dumps({"phase": "cli", "files": 3 + len(wavs),
                      "byte_exact": True, "seconds": cli_s,
                      "dsd_raw_byte_exact": True, "dsd_raw_seconds": raw_s,
                      "encoded_wavs": len(wavs), "encode_seconds": enc_s,
                      "encoded_bytes": {k: len(v)
                                        for k, v in encoded.items()}}))

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")

    rows = [
        ("entropy_decode[lossless]", "entropy.cu", "entropy_pallas.py:115",
         l_launches["entropy"], lossless["entropy"]),
        ("entropy_decode[hybrid]", "entropy.cu", "entropy_pallas.py:115",
         h_launches["entropy"], hybrid["entropy"]),
        ("entropy_decode[hybrid_wvc]", "entropy.cu", "entropy_pallas.py:115",
         c_launches["entropy_wvc"], wvc["entropy_wvc"]),
        ("decorr_post[packed]", "decorr.cu", "decorr_pallas.py:163",
         l_launches["decorr"], lossless["decorr_packed"]),
        ("decorr_post", "decorr.cu", "decorr_pallas.py:163", 0,
         lossless["decorr"]),
        ("decorr_post[wvc]", "decorr.cu", "decorr_pallas.py:163",
         c_launches["decorr_wvc"], wvc["decorr_wvc"]),
        ("decorr_post[generic]", "decorr.cu", "decorr_pallas.py:163",
         l_launches.get("decorr:generic", 0), lossless["decorr_generic"]),
        ("decorr_post[packed, mixed_chains]", "decorr.cu",
         "decorr_pallas.py:163", m_launches["decorr"],
         mixed["decorr_packed"]),
        ("decorr_post[mixed_chains]", "decorr.cu", "decorr_pallas.py:163", 0,
         mixed["decorr"]),
        ("decorr_post[packed, hybrid]", "decorr.cu", "decorr_pallas.py:163",
         h_launches["decorr"], hybrid["decorr_packed"]),
        ("decorr_post[packed, very_high]", "decorr.cu",
         "decorr_pallas.py:163", v_launches["decorr"],
         very_high["decorr_packed"]),
        ("decorr_post[very_high]", "decorr.cu", "decorr_pallas.py:163", 0,
         very_high["decorr"]),
        ("wvx_inject", "wvx.cu", "post.py:145", x_launches["wvx"],
         wvx["wvx"]),
        ("wvc_corrections", "wvc.cu", "entropy.py:352", c_launches["wvc"],
         wvc["wvc"]),
        ("dsd_fast_decode[bins4]", "dsd_fast.cu", "dsd_pallas.py:422",
         d_launches["dsd_fast"], dsd["dsd_fast_bins4"]),
        ("dsd_fast_decode[bins32]", "dsd_fast.cu", "dsd_pallas.py:422",
         d_launches["dsd_fast"], dsd["dsd_fast_bins32"]),
        ("dsd_high_decode", "dsd_high.cu", "dsd_pallas.py:78",
         d_launches["dsd_high"], dsd["dsd_high"]),
        ("encode_invert", "encode_invert.cu", "encode_pallas.py:98",
         e_launches["encode_invert"], enc["invert"]),
        ("encode_invert[warm]", "encode_invert.cu", "encode_pallas.py:98",
         e_launches["encode_invert[warm]"], enc["invert_warm"]),
        ("encode_invert[generic]", "encode_invert.cu", "encode_pallas.py:98",
         e_launches.get("encode_invert:generic", 0),
         enc["invert"]["generic"]),
        ("encode_invert[warm, generic]", "encode_invert.cu",
         "encode_pallas.py:98",
         e_launches.get("encode_invert:generic[state]", 0),
         enc["invert_warm"]["generic"]),
        ("encode_words", "encode_words.cu", "encode_pallas.py:373",
         e_launches["encode_words"], enc["words"]),
        ("encode_hybrid", "encode_hybrid.cu", "encode_pallas.py:566",
         e_launches["encode_hybrid"], enc["hybrid"]),
        ("encode_hybrid[generic]", "encode_hybrid.cu", "encode_pallas.py:566",
         e_launches.get("encode_hybrid:generic", 0),
         enc["hybrid"]["generic"]),
    ]
    # the encode kernels' other instantiations on 64 lanes; launches: the
    # instantiation's in the encode_device runs (0 for those the track's
    # calls do not run)
    for name, r in enc["variants"].items():
        kind, _, variant = name.partition("_")
        ((inst, _n),) = r["instances"].items()
        src, rep = {"invert": ("encode_invert.cu", "encode_pallas.py:98"),
                    "hybrid": ("encode_hybrid.cu", "encode_pallas.py:566")
                    }[kind]
        rows.append((f"encode_{kind}[{variant}, 64 lanes]", src, rep,
                     e_launches.get(f"encode_{kind}:{inst}", 0), r))
    # no PyTorch or CUDA library call computes these coders: library_ms is
    # null; the bound is the bytes moved (integer work only)
    # dsd_high's and the word coders' rows also give the lanes their int64
    # body ran
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"wvpk_torch/csrc/{src}",
         "replaces": f"wvpk/ops/{rep}", "launches": n,
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         **({"int64_lanes": r["int64_lanes"]}
            if r.get("int64_lanes") is not None else {})}
        for name, src, rep, n, r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
