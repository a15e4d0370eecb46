"""The bucket decode pipeline (port of wvpk/engine/pipeline.py).

Per call: parse-side block states -> buckets (host staging) -> per bucket
one host-to-device blob and its fused program (entropy, decorrelation
with joint/mute/CRC folded in, wvx injection for int32+wvx buckets, the
correction scan for hybrid buckets paired with a .wvc, fixup and the byte
pack; on a bucket of `packed_route`, the decorrelation kernel writes the
packed payload itself), and per DSD profile group its decode
(dsd_pipeline.py), all queued
on the device -> ONE batched device-to-host copy for every bucket's and
group's results -> `DecodedBlock`s on the host. The host only
parses containers and reassembles outputs (reference UnpackUtils.cs:
510-686 splits at the same place: unpack_init on the host, the sample
math on the device). With `DecodeOptions.delivery_chunk_blocks` the PCM
blocks go in chunks, each chunk's copy overlapping the next chunk's
staging and launches (`run_decode`); with a mesh (parallel/mesh.py) each
bucket's and group's lanes are sharded over several devices.

Traced (trace.py), a call is the `decode` span (`#blocks`, `#buckets`,
`#chunks`) over `staging`, `launch` (enqueue only; `#h2d_bytes`; `#lanes`,
every PCM lane launched, `#packed_lanes`, those on the packed route, and
`#chain_lanes` / `#generic_lanes`, those whose chain routes them to a
compiled chain kernel or to the generic one, ops/decorr_cuda.py::lane_runs,
and `#cluster_lanes`, those of the chain kernels that run on a cluster),
`transfer` and `finalize`, a chunk at a time; `transfer` holds
`transfer.enqueue` (`_start_fetch`), then `transfer.wait` (the host
blocked on the queued work: under a collector the stream, or the event
an overlapped copy waits for, is synchronised before the copy),
`transfer.copy` (a copy made there, with `#bytes`; with chunked
delivery, the wait for the tail of the copy queued at enqueue, whose
bytes count there) and `transfer.split`.

A hybrid float block paired with a .wvc decodes with the float restore
(the profile's `is_float`, as both oracles do, ref/oracle.py), so the port
gives the oracle's samples; wvpk's fused path keeps a fault there: its wvc
program hard-codes `is_float=False` (wvpk/engine/fused.py:129-130).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import consts, trace
from ..config import get_options
from ..container.blockstate import BlockState
from ..debug import check_against_oracle
from ..device import copy_stream
from ..ops.decorr_cuda import CLUSTER, GENERIC, lane_runs
from ..parallel.mesh import launch_sharded_bucket, make_mesh
from .dsd_pipeline import fetch_list, finalize_dsd_groups, launch_dsd_states
from .fused import DEVICE_FIELDS, WVX_FIELDS, deliver, fused_decode, \
    fused_decode_wvc, fused_decode_wvx
from .staging import Bucket, _chain_of, group_blocks, profile_of


@dataclass
class DecodedBlock:
    samples: np.ndarray    # (n, ch_out) int32 (FALSE_STEREO already dup'd)
    crc: int
    crc_x: int
    mute_error: bool
    crc_error: bool
    crc_wvc: int = -1
    wvc_applied: bool = False


@dataclass
class LaunchedBucket:
    """One bucket's decode, queued on the device until the batched fetch:
    the PCM payload and one stacked (crc, mute, crc_x[, crc_wvc]) table."""
    bucket: Bucket
    payload: torch.Tensor      # (L, W) packed PCM words or (T, L, C) int32
    crcmute: torch.Tensor      # (3, L) int32, (4, L) for a wvc bucket
    bps: int | None            # packed bytes/sample, None = raw int32


def _bucket_bps(b: Bucket) -> int | None:
    """Packed delivery width: set when every lane agrees on bytes_stored
    and packing shrinks the copy (reference analog: the demo's format loop
    WvDemo.cs:117-141 packing to bytes_per_sample). Never for float: the
    float restore delivers 24-bit values in 4 bytes."""
    if b.profile.is_float:
        return None
    bs = b.bytes_stored
    if len(bs) == 0 or (bs != bs[0]).any():
        return None
    bps = int(bs[0]) + 1
    return bps if bps in (1, 2, 3) else None


def decode_tensors(b: Bucket, t: dict[str, torch.Tensor],
                   pack_bps: int | None = None):
    """Run a staged bucket's fused program (`t` from bucket_tensors): the
    wvc program for a bucket paired with correction streams, the wvx one
    for int32+wvx, the plain one otherwise, with `pack_bps` (a bucket of
    `packed_route`) on its packed route. Returns (out, crc, mute, crc_x or
    None, crc_wvc or None); `out` is the packed payload given pack_bps."""
    prof = b.profile
    base = {k: t[k] for k in DEVICE_FIELDS}
    hyb = dict(mono=prof.mono, hybrid_bitrate=prof.hybrid_bitrate,
               hybrid_balance=prof.hybrid_balance, nsteps=prof.nsteps,
               static_terms=b.static_terms, chain_segments=b.chain_segments)
    if prof.has_wvc:
        out, crc, mute, crc_wvc = fused_decode_wvc(
            **base, wvc_words=t["wvc_words"], is_float=prof.is_float,
            int32_expand=prof.is_int32, **hyb)
        return out, crc, mute, None, crc_wvc
    if prof.has_wvx:
        fs = any(st.flags & consts.FALSE_STEREO for st in b.states)
        out, crc, mute, crc_x = fused_decode_wvx(
            **base, **{k: t[k] for k in WVX_FIELDS},
            false_stereo=t["false_stereo"], hybrid=prof.hybrid,
            has_false_stereo=fs, **hyb)
        return out, crc, mute, crc_x, None
    out, crc, mute = fused_decode(
        **base, hybrid=prof.hybrid, is_float=prof.is_float,
        int32_expand=prof.is_int32, pack_bps=pack_bps, **hyb)
    return out, crc, mute, None, None


def delivery_bps(b: Bucket) -> int | None:
    """The packed width a bucket's payload is delivered at (None: int32
    samples)."""
    return _bucket_bps(b) if get_options().packed_delivery else None


def packed_route(b: Bucket) -> int | None:
    """The width at which the decorrelation kernel writes a bucket's
    delivered payload itself (fused_decode's `pack_bps`): delivery_bps for
    a bucket of the plain program (no wvx or wvc stream) that is integer
    and not int32-expanded; None where the samples go through fixup and
    pack_samples (or are delivered as int32)."""
    prof = b.profile
    if prof.has_wvc or prof.has_wvx or prof.is_float or prof.is_int32:
        return None
    return delivery_bps(b)


def deliver_bucket(b: Bucket, t: dict[str, torch.Tensor]):
    """A staged bucket's fused program and its two results for the host:
    (payload, crcmute) as fused.deliver gives them. Counts its lanes in
    the open span (`#lanes`, `#packed_lanes`, and by the decorrelation
    kernel their chains route them to, `#chain_lanes` and
    `#generic_lanes`, and of the former `#cluster_lanes`: on the CPU the
    plain version runs in its place)."""
    packed = packed_route(b)
    L = len(b.states)
    runs = lane_runs(L, b.profile.mono, b.static_terms, b.chain_segments)
    chain = sum(e - s for k, s, e in runs if k != GENERIC)
    trace.count("lanes", L)
    trace.count("packed_lanes", L if packed else 0)
    trace.count("chain_lanes", chain)
    trace.count("generic_lanes", L - chain)
    trace.count("cluster_lanes", sum(e - s for k, s, e in runs
                                     if k in CLUSTER))
    out, crc, mute, crc_x, crc_wvc = decode_tensors(b, t, pack_bps=packed)
    return deliver(out, crc, mute, None if packed else delivery_bps(b),
                   crc_x=crc_x, crc_wvc=crc_wvc)


def _unpack_lane(raw_words: np.ndarray, n_vals: int, bps: int,
                 C: int) -> np.ndarray:
    """Host-side inverse of ops.pack.pack_samples for one lane."""
    by = raw_words.view(np.uint8)[:n_vals * bps]
    if bps == 1:
        v = by.astype(np.int32) - 128
    elif bps == 2:
        v = by.view("<i2").astype(np.int32)
    else:
        b3 = by.reshape(-1, 3).astype(np.int32)
        v = b3[:, 0] | (b3[:, 1] << 8) | (b3[:, 2] << 16)
        v = (v ^ 0x800000) - 0x800000
    return v.reshape(-1, C)


def finalize_bucket(lb: LaunchedBucket, cm: np.ndarray,
                    payload_np: np.ndarray) -> list[DecodedBlock]:
    b = lb.bucket
    prof = b.profile
    crc_np, mute_np, crc_x = cm[0], cm[1], cm[2]
    C = 1 if prof.mono else 2
    results = []
    for i, st in enumerate(b.states):
        n = int(b.nsamples[i])
        if lb.bps is not None:
            vals = _unpack_lane(payload_np[i], n * C, lb.bps, C)
        else:
            vals = payload_np[:n, i, :]
        if st.flags & consts.FALSE_STEREO:
            vals = np.repeat(vals, 2, axis=1)
        crc_err = (int(crc_np[i]) != st.header.crc
                   or (prof.has_wvx and int(crc_x[i]) != st.crc_mvx))
        crc_wvc = -1
        if prof.has_wvc:
            crc_wvc = int(cm[3][i])
            crc_err = crc_err or crc_wvc != int(b.wvc_crc[i])
        results.append(DecodedBlock(
            samples=np.ascontiguousarray(vals),
            crc=int(crc_np[i]), crc_x=int(crc_x[i]),
            mute_error=bool(mute_np[i]), crc_error=bool(crc_err),
            crc_wvc=crc_wvc, wvc_applied=prof.has_wvc))
    return results


@trace.stage("transfer.enqueue")
def _start_fetch(arrs: list[torch.Tensor], overlap: bool = False):
    """Queue ONE device-to-host copy per device for a list of int32 tensors
    (flattened and concatenated on their device), so per-copy latency is
    paid once however many buckets a call has. With `overlap`, a CUDA
    device's copy goes without blocking into a pinned host tensor on the
    device's copy stream, between two events (`ready`, recorded on the
    current stream, which the copy waits for, and `done`), and the host
    goes on while it runs; its bytes count here (`#bytes`), as the copy
    is queued. Otherwise _finish_fetch makes the copy. Returns the handle
    _finish_fetch takes."""
    by_dev: dict[torch.device, list[int]] = {}
    for i, a in enumerate(arrs):
        by_dev.setdefault(a.device, []).append(i)
    parts = []
    for dev, idx in by_dev.items():
        blob = torch.cat([arrs[i].reshape(-1) for i in idx])
        events = None
        if overlap and dev.type == "cuda":
            host = torch.empty(blob.shape, dtype=blob.dtype, pin_memory=True)
            stream = copy_stream(dev)
            ready, done = torch.cuda.Event(), torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
            stream.wait_event(ready)
            with torch.cuda.stream(stream):
                host.copy_(blob, non_blocking=True)
                done.record(stream)
            blob.record_stream(stream)
            trace.count("bytes", host.nbytes)
            blob, events = host, (ready, done)
        parts.append((blob, events, idx))
    return parts, [tuple(a.shape) for a in arrs]


def _finish_fetch(handle) -> list[np.ndarray]:
    """The host arrays of a _start_fetch handle, in the order given.
    `transfer.wait` holds the host's wait for the queued device work (an
    overlapped copy's `ready` event; traced, the blob's stream is
    synchronised before a copy made here, which would wait for it anyway),
    `transfer.copy` the copy: one made here, with its `#bytes`, or the
    wait for an overlapped copy's `done` event, which ran while the host
    went on and whose bytes counted at `_start_fetch`."""
    parts, shapes = handle
    out: list = [None] * len(shapes)
    for blob, events, idx in parts:
        with trace.stage("transfer.wait"):
            if events is not None:
                events[0].synchronize()
            elif blob.is_cuda and trace.active():
                torch.cuda.current_stream(blob.device).synchronize()
        with trace.stage("transfer.copy"):
            if events is not None:
                events[1].synchronize()
                host = blob.numpy()
            else:
                host = blob.cpu().numpy()
                trace.count("bytes", host.nbytes)
        with trace.stage("transfer.split"):
            pos = 0
            for i in idx:
                n = int(np.prod(shapes[i]))
                out[i] = host[pos:pos + n].reshape(shapes[i])
                pos += n
    return out


@trace.stage("transfer")
def _fetch_arrays(arrs: list[torch.Tensor]) -> list[np.ndarray]:
    """One batched device-to-host copy a device for a list of int32
    tensors (_start_fetch), made now."""
    return _finish_fetch(_start_fetch(arrs))


def _chunks(pcm_states: list[BlockState]) -> list[list[int]]:
    """The PCM blocks' positions cut into delivery chunks (wvpk's rule):
    with `delivery_chunk_blocks` CH set and more than CH * 3 // 2 blocks,
    the blocks sorted by (profile, term chain) and cut at every profile
    change and every CH blocks, so each chunk stages to few buckets; one
    chunk otherwise."""
    CH = get_options().delivery_chunk_blocks
    if not (CH and len(pcm_states) > CH * 3 // 2):
        return [list(range(len(pcm_states)))]
    profs = [profile_of(st) for st in pcm_states]
    order = sorted(range(len(pcm_states)),
                   key=lambda i: (repr(profs[i]), _chain_of(pcm_states[i])))
    chunks, run = [], []
    for i in order:
        if run and (profs[i] != profs[run[-1]] or len(run) >= CH):
            chunks.append(run)
            run = []
        run.append(i)
    chunks.append(run)
    return chunks


def decode_states(states: list[BlockState],
                  device: str | torch.device = "cuda") -> list[DecodedBlock]:
    """Decode a list of blocks (any mix of PCM profiles and DSD modes) on
    `device`. Every PCM bucket and DSD group is queued first, and all
    results (PCM payloads, packed DSD bytes, CRC/mute tables) come back in
    one batched copy, so a mixed call pays the fetch latency once; with
    `delivery_chunk_blocks` set, in one copy a chunk (run_decode)."""
    return run_decode(states, make_mesh(devices=[device]))


@trace.stage("decode")
def run_decode(states: list[BlockState],
               mesh: list[torch.device]) -> list[DecodedBlock]:
    """decode_states with every PCM bucket's and DSD group's lanes sharded
    over `mesh` (parallel.make_mesh; a mesh of one device is the unsharded
    decode).

    The PCM blocks go in delivery chunks (_chunks). Chunk k+1 is staged
    and launched while chunk k's results copy to the host, and chunk k
    is finalized once its copy has landed; the DSD groups are queued
    first and ride in the last chunk's copy. With one chunk this is one
    batched copy for the whole call. With `oracle_check` every block is
    held against the scalar oracle at the end, samples and status
    (debug.check_against_oracle)."""
    results: list[DecodedBlock | None] = [None] * len(states)
    pcm_states, pcm_indices = [], []
    dsd_states, dsd_indices = [], []
    for i, st in enumerate(states):
        if st.flags & consts.DSD_FLAG:
            dsd_states.append(st)
            dsd_indices.append(i)
        elif st.header.block_samples == 0:
            results[i] = DecodedBlock(
                samples=np.zeros((0, 1), np.int32), crc=-1, crc_x=-1,
                mute_error=False, crc_error=False)
        else:
            pcm_states.append(st)
            pcm_indices.append(i)
    chunks = _chunks(pcm_states)
    trace.count("blocks", len(states))
    trace.count("chunks", len(chunks))
    dsd_launched = (launch_dsd_states(dsd_states, mesh[0], mesh)
                    if dsd_states else [])

    def launch(k):
        chunk = chunks[k]
        with trace.stage("staging"):
            buckets = group_blocks([pcm_states[i] for i in chunk])
        trace.count("buckets", len(buckets))
        with trace.stage("launch"):
            launched = [lb for b in buckets
                        for lb in launch_sharded_bucket(b, mesh)]
        last = k == len(chunks) - 1
        arrs = [a for lb in launched for a in (lb.crcmute, lb.payload)]
        with trace.stage("transfer"):
            handle = _start_fetch(
                arrs + (fetch_list(dsd_launched) if last else []),
                overlap=len(chunks) > 1)
        return chunk, launched, last, handle

    def consume(chunk, launched, last, handle):
        with trace.stage("transfer"):
            fetched = _finish_fetch(handle)
        with trace.stage("finalize"):
            for k, lb in enumerate(launched):
                blocks = finalize_bucket(lb, fetched[2 * k],
                                         fetched[2 * k + 1])
                for j, res in zip(lb.bucket.indices, blocks):
                    results[pcm_indices[chunk[j]]] = res
            if last:
                for j, res in finalize_dsd_groups(
                        dsd_launched, fetched[2 * len(launched):]):
                    results[dsd_indices[j]] = res

    inflight = launch(0)
    for k in range(len(chunks)):
        following = launch(k + 1) if k + 1 < len(chunks) else None
        consume(*inflight)
        inflight = following
    if get_options().oracle_check:
        check_against_oracle(states, results)
    return results


def decode_bytes(data: bytes, device: str | torch.device = "cuda"
                 ) -> tuple[list, list[DecodedBlock]]:
    """Parse a .wv byte string and decode every block on `device`."""
    from ..container import parse_blocks
    blocks = parse_blocks(data)
    return blocks, decode_states([b.state for b in blocks], device)
