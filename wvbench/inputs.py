"""The cell's inputs, made from the seed in a pool of worker processes.

A traffic mix names a pool of files and their lengths; each file is
synthesised (`gen.synth`) and, for a decode mix, encoded by the frozen
generator (`gen.encoder`) into `.wv` bytes. Lengths are a
stratified grid over the mix's range, the same set for every seed, which
only assigns them to files: every seed does the same amount of work.
Tracks are made in segments of whole blocks, SEGMENT_SECONDS long, one
job each, so the pool's workers stay busy; each segment starts the encoder
afresh (its blocks seed themselves, as every WavPack block does). The
segment length is how the work is split, not traffic: no mix sets it.
Workers import numpy and the generator only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .gen import synth
from .gen.encoder import EncodeSpec, encode_blocks
from .ref import consts
from .ref.files import block_spans, payload_bytes

# rng streams of a run's seed
STREAM_CONTENT, STREAM_LENGTHS, STREAM_CALLS, STREAM_WARM, STREAM_CHECK = \
    range(5)
SEGMENT_SECONDS = 30


@dataclass
class File:
    """One file of the pool: its source PCM and, for decode mixes, its
    stream with the reference's index of it."""
    index: int
    frames: int
    pcm: np.ndarray                   # (frames, 2) int16
    wv: bytes | None = None
    spans: list | None = None         # block_spans(wv)
    payload: int = 0                  # ID_WV_BITSTREAM bytes


def lengths(seed: int, traffic: dict, rate: int) -> list[int]:
    """Frames of each pool file: the grid lo + (k + 1/2) (hi - lo) / n
    seconds, k = 0..n-1, in an order drawn from the seed."""
    n = traffic["pool_files"]
    lo, hi = traffic["seconds_min"], traffic["seconds_max"]
    grid = [int(round((lo + (k + 0.5) * (hi - lo) / n) * rate))
            for k in range(n)]
    order = synth.rng_for(seed, STREAM_LENGTHS).permutation(n)
    return [grid[i] for i in order]


def spec_of(config: dict) -> EncodeSpec:
    """The generator's EncodeSpec for a configuration."""
    return EncodeSpec(
        block_samples=config["block_samples"], joint=config["joint_stereo"],
        terms=tuple(config["terms"]), deltas=tuple(config["deltas"]),
        bytes_stored=config["bits_per_sample"] // 8,
        sample_rate=config["sample_rate"], hybrid=config["hybrid"])


def make_segment(job: tuple) -> tuple:
    """Worker job: one segment of a file, (seed, file index, segment
    number, segment start, segment frames, file frames, config dict or
    None) -> (pcm, wv bytes); no encode without a config."""
    seed, index, seg_no, start, n, total, config = job
    pcm = synth.track(seed, (index << 16) + seg_no, n,
                      stream=STREAM_CONTENT,
                      rate=config["sample_rate"] if config else synth.RATE)
    if config is None:
        return pcm, None
    spec = spec_of(config)
    spec.total_samples_override = total
    blocks = encode_blocks(pcm, spec, start_sample=start,
                           first=start == 0, last=start + n >= total)
    return pcm, b"".join(blocks)


def make_pool(seed: int, config: dict, traffic: dict, pool,
              encode: bool) -> list[File]:
    """The mix's files for `seed`; `pool` maps jobs (a
    multiprocessing pool, or anything with `map`)."""
    rate = config["sample_rate"]
    seg = config["block_samples"] * max(
        1, SEGMENT_SECONDS * rate // config["block_samples"])
    jobs = []
    for i, total in enumerate(lengths(seed, traffic, rate)):
        for k, start in enumerate(range(0, total, seg)):
            jobs.append((seed, i, k, start, min(seg, total - start), total,
                         config if encode else None))
    parts = pool.map(make_segment, jobs, chunksize=1)
    files: list[File] = []
    for job, (pcm, wv) in zip(jobs, parts):
        i = job[1]
        if i == len(files):
            files.append(File(i, job[5], [], [] if encode else None))
        f = files[i]
        f.pcm.append(pcm)
        if encode:
            f.wv.append(wv)
    for f in files:
        f.pcm = np.concatenate(f.pcm)
        if encode:
            f.wv = b"".join(f.wv)
            f.spans = block_spans(f.wv)
            f.payload = payload_bytes(f.wv, consts.ID_WV_BITSTREAM)
    return files
