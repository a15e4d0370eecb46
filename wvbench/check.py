"""How `correct` is decided: the program's answers against the plain
reference, once the window has closed.

Decode cells (lossless at the output, so the answer is the source PCM the
benchmark synthesised):
- every call in the window: blocks whose status says CRC error or mute
  (`bad_status_blocks`) and frames missing or extra against the block
  headers' count (`missing_frames`);
- the calls a seeded reservoir kept: every frame against the source PCM
  (`pcm_mismatch_frames`);
- REF_BLOCKS_DECODE blocks drawn from the seed out of those calls,
  decoded alone by the frozen scalar decoder (`ref/oracle.py`) from the
  same bytes: the program's frames against it (`ref_mismatch_frames`),
  and the reference itself against the source and its own status
  (`ref_vs_source_frames`, `ref_bad_status_blocks`), which guard the
  yardstick.
Encode cells: every call's stream indexed by the reference
(`stream_errors`: blocks out of order, sizes, flags) and every block's
CRC against the source (`crc_mismatch_blocks`). The program writes each
CRC from its own input, so these guard the stream's structure and the
CRC, not the payload: REF_BLOCKS_ENCODE blocks drawn from the seed
without replacement over every kept call are decoded by the reference
against the source (`ref_mismatch_frames`, `ref_bad_status_blocks`).

Each number has the limit 0: every comparison is exact. The control
(`--control 1`) breaks the configuration's guarantee, lossless output:
the reference in the program's place at 15 bits (the source's lowest bit
dropped), which must come out not correct.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .ref import consts
from .ref.files import block_crc, block_spans, decode_alone

LIMIT = 0
# blocks the reference decodes after the window (~0.9 s a 22,050-sample
# block on one core, on the pool's 8 workers): a decode cell holds every
# frame of its kept calls against the source already; an encode cell's
# payload is seen by the reference alone, so it draws many more
REF_BLOCKS_DECODE = 16
REF_BLOCKS_ENCODE = 224


@dataclass
class Record:
    """What the window leaves for the check."""
    bad_status_blocks: int = 0
    missing_frames: int = 0
    kept: list = field(default_factory=list)     # [(files, outs)]
    seen: int = 0

    def keep(self, rng, k: int, files: list, outs: list) -> None:
        """Reservoir of `k` calls, uniform over every call in the window."""
        if len(self.kept) < k:
            self.kept.append((files, outs))
        else:
            j = int(rng.integers(0, self.seen + 1))
            if j < k:
                self.kept[j] = (files, outs)
        self.seen += 1


def mismatched(out: np.ndarray, exp: np.ndarray) -> int:
    """Frames of `out` that differ from `exp`, counting missing or extra
    frames as differing."""
    n = min(len(out), len(exp))
    if out.ndim != 2 or out.shape[1] != exp.shape[1]:
        return max(len(out), len(exp))
    diff = int(np.count_nonzero(np.any(out[:n] != exp[:n], axis=1)))
    return diff + abs(len(out) - len(exp))


def missing(files: list, outs: list) -> int:
    """Frames the call owes against the headers' count, per file."""
    got = [len(o) for o in outs] + [0] * (len(files) - len(outs))
    return sum(abs(f.frames - n) for f, n in zip(files, got))


def lsb_dropped(pcm: np.ndarray) -> np.ndarray:
    return pcm.astype(np.int32) & ~1


def encode_job(job):
    """Worker job: the generator's stream of a whole file's PCM."""
    from .gen.encoder import encode_blocks
    from .inputs import spec_of
    pcm, config = job
    return b"".join(encode_blocks(pcm, spec_of(config)))


def _draw_blocks(rng, calls: list, n: int):
    """`n` distinct (call, file position, block number), or every one
    there is, drawn from the seed uniformly over the blocks of all the
    calls, given as lists of (File, output)."""
    where = []
    for c, call in enumerate(calls):
        for j, (f, out) in enumerate(call):
            nblocks = len(f.spans) if f.spans is not None else \
                len(block_spans(out))
            where.extend((c, j, b) for b in range(nblocks))
    if len(where) <= n:
        return where
    return [where[int(k)] for k in
            np.sort(rng.choice(len(where), size=n, replace=False))]


def check_decode(files, rec: Record, pool, rng, control: bool) -> dict:
    nums = {"bad_status_blocks": rec.bad_status_blocks,
            "missing_frames": rec.missing_frames}
    calls = [[(files[i], out) for i, out in zip(idx, outs)]
             for idx, outs in rec.kept]
    if control:
        calls = [[(f, lsb_dropped(f.pcm)) for f, _ in c] for c in calls]
    nums["pcm_mismatch_frames"] = sum(mismatched(out, f.pcm)
                                      for c in calls for f, out in c)
    picks = _draw_blocks(rng, calls, REF_BLOCKS_DECODE)
    jobs = []
    for c, j, b in picks:
        f = calls[c][j][0]
        s, e, _, _ = f.spans[b]
        jobs.append(f.wv[s:e])
    ref_mis = ref_src = ref_bad = 0
    for (c, j, b), (ref, crc_err, mute) in zip(
            picks, pool.map(decode_alone, jobs, chunksize=1)):
        f, out = calls[c][j]
        _, _, start, n = f.spans[b]
        ref_mis += mismatched(out[start:start + n], ref)
        ref_src += mismatched(ref, f.pcm[start:start + n])
        ref_bad += int(crc_err or mute)
    nums["ref_mismatch_frames"] = ref_mis
    nums["ref_vs_source_frames"] = ref_src
    nums["ref_bad_status_blocks"] = ref_bad
    return nums


def _stream_errors(wv: bytes, f, config: dict) -> tuple[int, int]:
    """(structure errors, blocks whose CRC differs from the source's) of
    one encoded stream of file `f`."""
    errors = crc_bad = 0
    pos = 0
    bs = config["block_samples"]
    spans = block_spans(wv)
    for k, (s, e, index, n) in enumerate(spans):
        last = k == len(spans) - 1
        flags = int.from_bytes(wv[s + 24:s + 28], "little")
        if (index != pos or (n != bs and not (last and 0 < n <= bs))
                or flags & consts.HYBRID_FLAG
                or bool(flags & consts.JOINT_STEREO) != config["joint_stereo"]
                or (flags & consts.BYTES_STORED) + 1
                != config["bits_per_sample"] // 8):
            errors += 1
        crc = int.from_bytes(wv[s + 28:s + 32], "little")
        if crc != block_crc(f.pcm[index:index + n]):
            crc_bad += 1
        pos = index + n
    if pos != f.frames:
        errors += 1
    return errors, crc_bad


def check_encode(files, rec: Record, pool, rng, control: bool,
                 config: dict) -> dict:
    calls = [[(files[i], out) for i, out in zip(idx, outs)]
             for idx, outs in rec.kept]
    picks = _draw_blocks(rng, calls, REF_BLOCKS_ENCODE)
    if control:
        redo = sorted({(c, j) for c, j, _ in picks})
        streams = pool.map(encode_job, [
            (lsb_dropped(calls[c][j][0].pcm), config) for c, j in redo],
            chunksize=1)
        for (c, j), wv in zip(redo, streams):
            calls[c][j] = (calls[c][j][0], wv)
    errors = crc_bad = 0
    for c in calls:
        for f, wv in c:
            e, b = _stream_errors(wv, f, config)
            errors += e
            crc_bad += b
    nums = {"stream_errors": errors, "crc_mismatch_blocks": crc_bad}
    jobs, where = [], []
    for c, j, b in picks:
        f, wv = calls[c][j]
        spans = block_spans(wv)
        if b >= len(spans):
            nums["stream_errors"] += 1
            continue
        s, e, start, n = spans[b]
        jobs.append(wv[s:e])
        where.append((f, start, n))
    ref_mis = ref_bad = 0
    for (f, start, n), (ref, crc_err, mute) in zip(
            where, pool.map(decode_alone, jobs, chunksize=1)):
        ref_mis += mismatched(ref, f.pcm[start:start + n])
        ref_bad += int(crc_err or mute)
    nums["ref_mismatch_frames"] = ref_mis
    nums["ref_bad_status_blocks"] = ref_bad
    return nums


def verdict(nums: dict) -> tuple[bool, dict]:
    """correct, and each number beside its limit."""
    shown = {k: {"value": v, "limit": LIMIT} for k, v in nums.items()}
    return all(v <= LIMIT for v in nums.values()), shown
