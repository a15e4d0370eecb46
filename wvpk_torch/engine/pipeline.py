"""The bucket decode pipeline (port of wvpk/engine/pipeline.py).

Per call: parse-side block states -> buckets (host staging) -> per bucket
one host-to-device blob and its fused program (entropy, decorrelation
with joint/mute/CRC folded in, wvx injection for int32+wvx buckets, the
correction scan for hybrid buckets paired with a .wvc, fixup and the byte
pack), and per DSD profile group its decode (dsd_pipeline.py), all queued
on the device -> ONE batched device-to-host copy for every bucket's and
group's results -> `DecodedBlock`s on the host. The host only
parses containers and reassembles outputs (reference UnpackUtils.cs:
510-686 splits at the same place: unpack_init on the host, the sample
math on the device).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import consts, trace
from ..config import get_options
from ..container.blockstate import BlockState
from ..device import resolve
from .dsd_pipeline import fetch_list, finalize_dsd_groups, launch_dsd_states
from .fused import DEVICE_FIELDS, WVX_FIELDS, deliver, fused_decode, \
    fused_decode_wvc, fused_decode_wvx
from .staging import Bucket, bucket_tensors, group_blocks


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


def decode_tensors(b: Bucket, t: dict[str, torch.Tensor]):
    """Run a staged bucket's fused program (`t` from bucket_tensors): the
    wvc program for a bucket paired with correction streams, the wvx one
    for int32+wvx, the plain one otherwise. Returns (out, crc, mute,
    crc_x or None, crc_wvc or None)."""
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
        int32_expand=prof.is_int32, **hyb)
    return out, crc, mute, None, None


def launch_bucket(b: Bucket, device: torch.device) -> LaunchedBucket:
    out, crc, mute, crc_x, crc_wvc = decode_tensors(
        b, bucket_tensors(b, device))
    bps = _bucket_bps(b) if get_options().packed_delivery else None
    payload, crcmute = deliver(out, crc, mute, bps, crc_x=crc_x,
                               crc_wvc=crc_wvc)
    return LaunchedBucket(bucket=b, payload=payload, crcmute=crcmute, bps=bps)


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


def _fetch_arrays(arrs: list[torch.Tensor]) -> list[np.ndarray]:
    """ONE device-to-host copy for a list of int32 device tensors: flatten,
    concatenate on the device, copy, then split on the host. Per-copy
    latency is paid once however many buckets a call has."""
    if not arrs:
        return []
    blob = torch.cat([a.reshape(-1) for a in arrs]).cpu().numpy()
    out, pos = [], 0
    for a in arrs:
        out.append(blob[pos:pos + a.numel()].reshape(tuple(a.shape)))
        pos += a.numel()
    return out


def decode_states(states: list[BlockState],
                  device: str | torch.device = "cuda") -> list[DecodedBlock]:
    """Decode a list of blocks (any mix of PCM profiles and DSD modes) on
    `device`. Every PCM bucket and DSD group is queued first, and all
    results (PCM payloads, packed DSD bytes, CRC/mute tables) come back in
    one batched copy, so a mixed call pays the fetch latency once."""
    dev = resolve(device)
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
    with trace.stage("staging"):
        buckets = group_blocks(pcm_states) if pcm_states else []
    with trace.stage("launch"):
        dsd_launched = (launch_dsd_states(dsd_states, dev) if dsd_states
                        else [])
        launched = [launch_bucket(b, dev) for b in buckets]
    with trace.stage("transfer"):
        fetched = _fetch_arrays([a for lb in launched
                                 for a in (lb.crcmute, lb.payload)]
                                + fetch_list(dsd_launched))
    with trace.stage("finalize"):
        for k, lb in enumerate(launched):
            blocks = finalize_bucket(lb, fetched[2 * k], fetched[2 * k + 1])
            for j, res in zip(lb.bucket.indices, blocks):
                results[pcm_indices[j]] = res
        for j, res in finalize_dsd_groups(dsd_launched,
                                          fetched[2 * len(launched):]):
            results[dsd_indices[j]] = res
    return results


def decode_bytes(data: bytes, device: str | torch.device = "cuda"
                 ) -> tuple[list, list[DecodedBlock]]:
    """Parse a .wv byte string and decode every block on `device`."""
    from ..container import parse_blocks
    blocks = parse_blocks(data)
    return blocks, decode_states([b.state for b in blocks], device)
