"""DSD block staging and decode, modes 0, 1 and 3 (port of
wvpk/engine/dsd_pipeline.py).

Mirrors the PCM pipeline: blocks are grouped by a profile (mode, mono,
history bins), each group's per-lane arrays go to the device, one kernel
decodes the group into each lane's row of byte-values (1 byte each, no
separate pack). `launch_dsd_states` only queues the work;
`decode_states` fetches every group's (crcerr, payload) in its one
batched device-to-host copy, beside the PCM buckets, and
`finalize_dsd_group` assembles the blocks: the block-end CRC check
(DsdUtils.cs:99-101), the 0x55 mute fill and FALSE_STEREO duplication
(:104-131).

The profile holds no step count or payload capacity (wvpk's static-shape
keys): a kernel stops each lane at its own counts, so a group is padded
to its longest lane (the payload rows to a multiple of 4 bytes) and a
call makes one launch per profile; on the card the mode-1 and mode-3
groups launch on side streams and run side by side (`decode_groups`).
The payload bytes stage as uint8 (L, cap), one copy of their own; the
other per-lane arrays travel as one int32 blob. Mode 0 is a byte copy:
its values stay on the host and only its CRC runs on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import consts, trace
from ..container.blockstate import BlockState
from ..device import run_side_by_side
from ..ops.dsd import dsd_raw_crc
from ..ops.dsd_select import dsd_fast_decode_any, dsd_high_decode_any
from ..parallel.mesh import shard_dsd_groups
from .fused import build_blob, to_device, unpack_blob


@dataclass(frozen=True)
class DsdProfile:
    mode: int
    mono: bool
    bins: int = 0


def _profile(st: BlockState) -> DsdProfile:
    mono = bool(st.flags & consts.MONO_DATA)
    mode = st.dsd.mode
    return DsdProfile(mode, mono, st.dsd.history_bins if mode == 1 else 0)


def _pad_bytes(payloads: list[bytes], cap: int) -> np.ndarray:
    out = np.zeros((len(payloads), cap), np.uint8)
    for i, p in enumerate(payloads):
        out[i, :len(p)] = np.frombuffer(p, np.uint8)
    return out


@dataclass
class DsdGroup:
    """One profile group staged on the host: the padded payload bytes
    (mode 0: the raw values) and the per-lane arrays its decode reads."""
    prof: DsdProfile
    idxs: list[int]                   # positions in the caller's list
    sts: list[BlockState]
    nvals: np.ndarray                 # (L,) delivered value counts
    data: np.ndarray                  # (L, cap) uint8
    arrays: dict[str, np.ndarray]
    nsteps: int                       # the decode's steps (a multiple of 4)


def group_dsd(states: list[BlockState]) -> list[DsdGroup]:
    """Group DSD blocks by profile and stage each group's arrays."""
    groups: dict[DsdProfile, list[int]] = {}
    for i, st in enumerate(states):
        groups.setdefault(_profile(st), []).append(i)
    out = []
    for prof, idxs in groups.items():
        sts = [states[i] for i in idxs]
        nsamples = np.asarray([st.header.block_samples for st in sts],
                              np.int32)
        nvals = nsamples * (1 if prof.mono else 2)
        lens = np.asarray([len(st.dsd.data) for st in sts], np.int32)
        # mode 1 steps over values, mode 3 over samples; a multiple of 4
        # so that every lane's row of output bytes is whole words
        steps = nvals if prof.mode == 1 else nsamples
        nsteps = -(-int(steps.max()) // 4) * 4
        if prof.mode == 0:
            data = _pad_bytes([st.dsd.data for st in sts],
                              max(int(nvals.max()), 1))
            arrays = {"neff": np.minimum(nvals, lens)}
        else:
            # the kernels read a payload row as aligned 32-bit words
            data = _pad_bytes([st.dsd.data for st in sts],
                              -(-max(int(lens.max()), 1) // 4) * 4)
            arrays = {"nbytes": lens,
                      "value0": np.asarray([st.dsd.value for st in sts],
                                           np.int64)}
        if prof.mode == 1:
            arrays["summed"] = np.stack(
                [st.dsd.summed_probabilities.astype(np.int32).reshape(-1)
                 for st in sts])
            arrays["nvals"] = nvals
        elif prof.mode == 3:
            arrays["ptable"] = np.stack([st.dsd.ptable for st in sts]
                                        ).astype(np.int32)
            arrays["filters"] = np.stack([st.dsd.filters for st in sts]
                                         ).astype(np.int32)
            arrays["nsamples"] = nsamples
        out.append(DsdGroup(prof, idxs, sts, nvals, data, arrays, nsteps))
    return out


def group_tensors(g: DsdGroup, device: torch.device
                  ) -> dict[str, torch.Tensor]:
    """A group's arrays on `device`: the payload bytes as one uint8 copy,
    the rest as one int32 blob."""
    blob, metas = build_blob(g.arrays)
    trace.count("h2d_bytes", blob.nbytes + g.data.nbytes)
    t = unpack_blob(to_device(blob, device), metas)
    t["data"] = to_device(g.data, device)
    return t


def decode_group(g: DsdGroup, t: dict[str, torch.Tensor]):
    """Run a staged group's decode. Returns (byte-values (L, W) uint8,
    each lane's row in its memory order, None for mode 0; crc (L,) int32;
    coder error (L,))."""
    prof = g.prof
    if prof.mode == 0:
        crc = dsd_raw_crc(t["data"], t["neff"])
        return None, crc, torch.zeros_like(crc)
    if prof.mode == 1:
        outs, err, crc = dsd_fast_decode_any(
            t["data"], t["nbytes"], t["summed"], t["value0"], t["nvals"],
            bins=prof.bins, mono=prof.mono, nsteps=g.nsteps)
        return outs, crc, err
    outs, crc = dsd_high_decode_any(
        t["data"], t["nbytes"], t["ptable"], t["filters"], t["value0"],
        t["nsamples"], mono=prof.mono, nsteps=g.nsteps)
    return outs, crc, torch.zeros_like(crc)


@dataclass
class LaunchedDsd:
    """One DSD profile group's queued decode. `payload` is the kernel's
    (L, W) uint8 rows of byte-values seen as (L, W / 4) int32, for the
    batched copy; None for mode 0, whose bytes never leave the host.
    `crcerr` is a (2, L) int32 device tensor [crc, coder error]."""
    prof: DsdProfile
    idxs: list[int]
    sts: list[BlockState]
    payload: torch.Tensor | None
    crcerr: torch.Tensor
    host_vals: list[np.ndarray] | None   # mode 0 raw values per state
    nvals: np.ndarray                    # (L,) delivered value counts


def deliver_group(g: DsdGroup, outs, crc, err) -> LaunchedDsd:
    """The byte rows as int32 words (a view, no copy) and [crc, err]
    stacked."""
    payload = None if outs is None else outs.view(torch.int32)
    crcerr = torch.stack([crc.to(torch.int32), err.to(torch.int32)])
    host_vals = None
    if g.prof.mode == 0:
        host_vals = [g.data[k, :g.nvals[k]].astype(np.int32)
                     for k in range(len(g.sts))]
    return LaunchedDsd(g.prof, g.idxs, g.sts, payload, crcerr, host_vals,
                       g.nvals)


def decode_groups(groups: list[DsdGroup],
                  staged: list[dict[str, torch.Tensor]]) -> list[tuple]:
    """decode_group of every group on its staged tensors. On a CUDA device
    each mode-1 and mode-3 group launches on a side stream of its own
    (device.run_side_by_side: forked from the device's current stream after
    the staging copies queued there, joined back into it after the last
    launch, every tensor recorded on the streams that use it), so that the
    groups' kernels run side by side; mode 0 stays on the current stream.
    The mode-3 groups launch first: they run the longest, and their blocks
    then take SMs before the mode-1 blocks fill the card around them. The
    groups may lie on several devices (a mesh's shards)."""
    coded = sorted((k for k, g in enumerate(groups) if g.prof.mode != 0),
                   key=lambda k: groups[k].prof.mode != 3)
    res = [None] * len(groups)
    outs = run_side_by_side([
        (staged[k]["data"].device, staged[k],
         lambda t, g=groups[k]: decode_group(g, t)) for k in coded])
    for k, out in zip(coded, outs):
        res[k] = out
    return [r if r is not None else decode_group(g, t)
            for r, g, t in zip(res, groups, staged)]


def launch_dsd_states(states: list[BlockState], device: torch.device,
                      mesh: list | None = None) -> list[LaunchedDsd]:
    """Queue every DSD profile group's decode on `device` (every group's
    staging first, then the launches, decode_groups); nothing is fetched
    here. With `mesh` (parallel.make_mesh; by default [device]) each
    mode-1 and mode-3 group's lanes split into a contiguous run a device
    (parallel.mesh.shard_dsd_groups), each a launch on its device; mode 0,
    a host byte copy and a CRC, stays whole on the mesh's first device, as
    in wvpk."""
    with trace.stage("staging"):
        groups, devices = shard_dsd_groups(group_dsd(states),
                                           mesh or [device])
    with trace.stage("launch"):
        staged = [group_tensors(g, dev) for g, dev in zip(groups, devices)]
        return [deliver_group(g, *res)
                for g, res in zip(groups, decode_groups(groups, staged))]


def finalize_dsd_group(ld: LaunchedDsd, crcerr: np.ndarray,
                       payload_np: np.ndarray | None) -> list:
    """One group's DecodedBlocks from its fetched (crcerr, payload)."""
    crc, err = crcerr[0], crcerr[1]
    out = []
    for k, st in enumerate(ld.sts):
        if ld.host_vals is not None:
            vals = ld.host_vals[k]
        else:
            vals = (payload_np[k].view(np.uint8)[:ld.nvals[k]]
                    .astype(np.int32))
        out.append(_assemble(st, vals, int(crc[k]), bool(err[k])))
    return out


def fetch_list(launched: list[LaunchedDsd]) -> list[torch.Tensor]:
    """The device tensors each group delivers, in order: its crcerr, then
    its payload where it has one."""
    return [a for ld in launched for a in (ld.crcerr, ld.payload)
            if a is not None]


def finalize_dsd_groups(launched: list[LaunchedDsd],
                        fetched: list[np.ndarray]) -> list[tuple[int, object]]:
    """(position in the launch's state list, DecodedBlock) of every block,
    from the host copies of `fetch_list(launched)`."""
    pairs, pos = [], 0
    for ld in launched:
        crcerr, payload = fetched[pos], None
        pos += 1
        if ld.payload is not None:
            payload = fetched[pos]
            pos += 1
        pairs += zip(ld.idxs, finalize_dsd_group(ld, crcerr, payload))
    return pairs


def decode_dsd_states(states: list[BlockState],
                      device: str | torch.device = "cuda") -> list:
    """Decode a list of DSD block states alone, in one batched fetch (the
    engine's decode_states shares that fetch with the PCM buckets)."""
    from ..device import resolve
    from .pipeline import _fetch_arrays

    launched = launch_dsd_states(states, resolve(device))
    results = [None] * len(states)
    for i, res in finalize_dsd_groups(
            launched, _fetch_arrays(fetch_list(launched))):
        results[i] = res
    return results


def _assemble(st: BlockState, interleaved: np.ndarray, crc: int,
              err: bool):
    from .pipeline import DecodedBlock

    hdr = st.header
    n = hdr.block_samples
    mute = err or crc != hdr.crc
    flags = st.flags
    if mute:
        # the reference zero-fills only what it decoded; with a CRC
        # mismatch the whole block is muted (0x55 fill,
        # DsdUtils.cs:104-117)
        interleaved = np.full_like(interleaved, 0x55)
    if flags & consts.FALSE_STEREO:
        out = np.repeat(interleaved[:n, None], 2, axis=1)
    elif flags & consts.MONO_FLAG:
        out = interleaved[:n, None]
    else:
        out = interleaved.reshape(-1, 2)[:n]
    return DecodedBlock(samples=np.ascontiguousarray(out.astype(np.int32)),
                        crc=crc, crc_x=-1, mute_error=mute, crc_error=mute)
