"""Lane sharding over a list of devices (port of wvpk/parallel/mesh.py).

Blocks are self-seeded (every block's metadata carries its decorrelation
and entropy state), so a batch decode or encode is pure data parallelism
over the lane (block) axis, with no collective on the hot path.

A mesh is a list of `torch.device`s (`make_mesh`). It may repeat a device
(["cpu", "cpu"], ["cuda:0", "cuda:0"]): torch has no virtual device mesh,
and a host may hold one GPU. Each shard is a contiguous run of a bucket's
lanes, the first L % n shards one lane longer than the others, so shards
may be uneven and nothing is padded (wvpk pads to a mesh multiple by
repeating lane 0, since shard_map needs equal shards); a shard with no
lanes (more devices than lanes) is skipped. Every shard's inputs are
staged first, then each shard runs on a side stream of its CUDA device
(device.run_side_by_side), so shards sharing a device run side by side;
on the CPU the shards run one after another. A mesh of one device is the
unsharded path: the engine's entry points take `mesh=None` as the mesh
[device], whose one shard is the whole bucket on the current stream. Outputs come back as exactly
L lanes: the decode's through the caller's batched fetch, the encode
scans' gathered on the mesh's first device, where the encoder packs them.

Every kernel of the unsharded path runs on each shard: a mixed-chain
bucket's `chain_segments` are cut to each shard's lanes and rebased to 0
(`shard_bucket`), so each shard keeps its chain kernels (wvpk's sharded
decode passes only `static_terms`, and its mixed buckets run the generic
arm).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from ..device import resolve, run_side_by_side


def make_mesh(n_devices: int | None = None,
              devices: list | None = None) -> list[torch.device]:
    """The devices to shard over: `devices` (names or torch.devices,
    repeats allowed), by default every visible CUDA device; the first
    `n_devices` of them when that is given. "cuda" names the current CUDA
    device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices= (e.g. ['cpu', 'cpu'])")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        dev = resolve(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh.append(dev)
    if n_devices is not None:
        if not 1 <= n_devices <= len(mesh):
            raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                             f"{len(mesh)} given")
        mesh = mesh[:n_devices]
    if not mesh:
        raise ValueError("make_mesh: no device")
    return mesh


def shard_ranges(L: int, n: int) -> list[tuple[int, int] | None]:
    """The (start, stop) lanes of each of `n` shards of `L` lanes, None
    for a shard that gets none."""
    base, extra = divmod(L, n)
    out, pos = [], 0
    for k in range(n):
        size = base + (k < extra)
        out.append((pos, pos + size) if size else None)
        pos += size
    return out


def _device_context(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def run_shards(mesh: list[torch.device], parts: list, stage, run) -> list:
    """`run(part, stage(part, device))` for each shard: `parts` is
    [(k, part)], shard k's host input, for the shards that have lanes.
    Every shard stages (on its device's current stream) before any runs,
    then the runs go side by side (device.run_side_by_side). Returns the
    runs' outputs in `parts` order."""
    staged = []
    for k, part in parts:
        with _device_context(mesh[k]):
            staged.append(stage(part, mesh[k]))
    return run_side_by_side([
        (mesh[k], (part, st), lambda x: run(*x))
        for (k, part), st in zip(parts, staged)])


# -- decode ------------------------------------------------------------------

def _cut_segments(b, start: int, stop: int) -> tuple | None:
    """A bucket's chain_segments cut to lanes [start, stop) and rebased to
    0; the generic tail's num_terms_max taken over the shard's lanes."""
    if not b.chain_segments:
        return None
    out = []
    for chain, s, e, _ntm in b.chain_segments:
        lo, hi = max(s, start), min(e, stop)
        if lo < hi:
            ntm = len(chain) if chain is not None \
                else max(int(np.max(b.num_terms[lo:hi])), 1)
            out.append((chain, lo - start, hi - start, ntm))
    return tuple(out)


def shard_bucket(b, start: int, stop: int):
    """Lanes [start, stop) of a staged bucket as a bucket of their own:
    every per-lane array, state and caller index sliced, the chain
    segments cut (`_cut_segments`). All of its lanes are the bucket
    itself."""
    if (start, stop) == (0, len(b.states)):
        return b
    lanes = {}
    for f in dataclasses.fields(b):
        v = getattr(b, f.name)
        if f.name not in ("profile", "chain_segments") and v is not None:
            lanes[f.name] = v[start:stop]
    return dataclasses.replace(b, **lanes,
                               chain_segments=_cut_segments(b, start, stop))


def _bucket_shards(b, n: int) -> list:
    return [(k, shard_bucket(b, *r))
            for k, r in enumerate(shard_ranges(len(b.states), n)) if r]


def launch_sharded_bucket(b, mesh: list[torch.device]) -> list:
    """One bucket's decode sharded over `mesh`: a LaunchedBucket a shard,
    each a sub-bucket whose `indices` are the caller's, for the batched
    fetch (engine/pipeline.py)."""
    from ..engine.pipeline import LaunchedBucket, delivery_bps, \
        deliver_bucket
    from ..engine.staging import bucket_tensors

    shards = _bucket_shards(b, len(mesh))
    outs = run_shards(mesh, shards, bucket_tensors, deliver_bucket)
    return [LaunchedBucket(sub, payload, crcmute, delivery_bps(sub))
            for (_k, sub), (payload, crcmute) in zip(shards, outs)]


def sharded_decode_bucket(b, mesh: list):
    """Decode one bucket with its lanes sharded over `mesh`. Returns wvpk's
    (out (T, L, C) int32, crc (L,), mute (L,), crc_x (L,), crc_wvc (L,) or
    None) as numpy; crc_x is -1 for a bucket without a wvx stream, crc_wvc
    None for one without a correction stream."""
    from ..engine.pipeline import decode_tensors
    from ..engine.staging import bucket_tensors

    mesh = make_mesh(devices=mesh)
    outs = run_shards(mesh, _bucket_shards(b, len(mesh)), bucket_tensors,
                      decode_tensors)
    out, crc, mute, crc_x, crc_wvc = (
        None if o[0] is None else
        np.concatenate([x.cpu().numpy() for x in o], axis=ax)
        for o, ax in zip(zip(*outs), (1, 0, 0, 0, 0)))
    if crc_x is None:
        crc_x = np.full(len(b.states), -1, np.int32)
    return out, crc, mute.astype(bool), crc_x, crc_wvc


def shard_dsd_groups(groups: list, mesh: list[torch.device]
                     ) -> tuple[list, list[torch.device]]:
    """Each mode-1 and mode-3 DSD group cut into a contiguous run of lanes
    a device (the payload rows, the per-lane arrays and the caller
    indices sliced; the step count kept); a mode-0 group (a host byte copy
    and a CRC) whole on the mesh's first device, as wvpk leaves it
    unsharded; a group whole on a mesh of one. Returns (groups, their
    devices)."""
    out, devices = [], []
    for g in groups:
        if g.prof.mode == 0 or len(mesh) == 1:
            out.append(g)
            devices.append(mesh[0])
            continue
        for k, r in enumerate(shard_ranges(len(g.sts), len(mesh))):
            if r is None:
                continue
            s, e = r
            out.append(dataclasses.replace(
                g, idxs=g.idxs[s:e], sts=g.sts[s:e], nvals=g.nvals[s:e],
                data=g.data[s:e],
                arrays={n: a[s:e] for n, a in g.arrays.items()}))
            devices.append(mesh[k])
    return out, devices


def sharded_decode_states(states, mesh: list):
    """Batch decode with every PCM bucket's and DSD group's lanes sharded
    over `mesh`: the mesh counterpart of `engine.decode_states`, with the
    same `DecodedBlock` list (order kept), so going from one device to N is
    a one-line change."""
    from ..engine.pipeline import run_decode

    return run_decode(states, make_mesh(devices=mesh))


# -- encode ------------------------------------------------------------------
# The scan bodies are engine/device_encoder.py's, looked up there at each
# call: its unsharded encode is these calls on a mesh of one.

def shard_lanes_call(fn, args, mesh: list, out_lane_axes: tuple[int, ...],
                     in_lane_axes: tuple[int, ...] | None = None) -> tuple:
    """`fn` over lane shards of `args` (tensors on any device, or numpy
    arrays): each arg is cut along its lane axis (`in_lane_axes`, 0 for
    every arg by default) into each shard's contiguous run and copied to
    the shard's device, `fn` runs there on its shard, and its i-th output
    is gathered along `out_lane_axes[i]` on the mesh's first device. On a
    mesh of one, nothing is cut or gathered."""
    mesh = make_mesh(devices=mesh)
    args = [torch.as_tensor(a) for a in args]
    axes = in_lane_axes or (0,) * len(args)
    L = args[0].shape[axes[0]]

    def stage(r, dev):
        s, e = r
        return [a.narrow(ax, s, e - s).contiguous().to(dev, non_blocking=True)
                for a, ax in zip(args, axes)]

    parts = [(k, r) for k, r in enumerate(shard_ranges(L, len(mesh))) if r]
    outs = run_shards(mesh, parts, stage, lambda _r, t: fn(*t))
    if len(outs) == 1:
        return tuple(o.to(mesh[0]) for o in outs[0])
    return tuple(torch.cat([o[i].to(mesh[0]) for o in outs], dim=ax)
                 for i, ax in enumerate(out_lane_axes))


def _zero_seeds(L: int, device) -> tuple:
    z16 = torch.zeros((L, 16), dtype=torch.int64, device=device)
    z168 = torch.zeros((L, 16, 8), dtype=torch.int64, device=device)
    return z16, z16, z168, z168


def sharded_encode_scans(targ, terms, deltas, num_terms, med0, nvals,
                         mesh: list, *, mono: bool,
                         static_terms: tuple | None = None,
                         seeds: tuple | None = None):
    """The lossless device-encode scans (decorrelation inversion, then the
    word coder) sharded over `mesh`. `seeds` is the optional (w0a, w0b,
    h0a, h0b) warm decorrelation state per lane (zeros otherwise). Returns
    words_any's (payload words (L, cap) int32, total bits (L,) int64) on
    the mesh's first device."""
    from ..engine import device_encoder as de

    if seeds is None:
        seeds = _zero_seeds(targ.shape[1], "cpu")
    fn = functools.partial(de.lossless_scans, mono=mono,
                           static_terms=static_terms)
    return shard_lanes_call(
        fn, (targ, terms, deltas, num_terms, med0, nvals, *seeds), mesh,
        out_lane_axes=(0, 0), in_lane_axes=(1,) + (0,) * 9)


def sharded_invert_warm_state(targ, terms, deltas, num_terms, mesh: list,
                              *, mono: bool,
                              static_terms: tuple | None = None):
    """The warm-seeding scan sharded over `mesh`: the decorrelation
    inversion over each block's first K samples (`targ` (K, L, C)) from
    zero seeds, returning only the final state (wa, wb, ha, hb) per lane,
    which encode_blocks_device quantizes into the block's metadata."""
    from ..engine import device_encoder as de

    fn = functools.partial(de.warm_state, mono=mono,
                           static_terms=static_terms)
    return shard_lanes_call(fn, (targ, terms, deltas, num_terms), mesh,
                            out_lane_axes=(0, 0, 0, 0),
                            in_lane_axes=(1, 0, 0, 0))


def sharded_hybrid_encode_scan(targ, terms, deltas, num_terms, med0, slow0,
                               acc0, delta0, nvals, w0a, w0b, h0a, h0b,
                               mesh: list, *, mono: bool,
                               hybrid_bitrate: bool, hybrid_balance: bool,
                               static_terms: tuple | None = None):
    """The fused hybrid encode scan sharded over `mesh` (the lossy
    reconstruction feedback is block-local). Returns hybrid_scan_any's
    (payload words, total bits, recon (T, L, C)) on the mesh's first
    device."""
    from ..engine import device_encoder as de

    fn = functools.partial(de.hybrid_scan_any, mono=mono,
                           hybrid_bitrate=hybrid_bitrate,
                           hybrid_balance=hybrid_balance,
                           static_terms=static_terms)
    return shard_lanes_call(
        fn, (targ, terms, deltas, num_terms, med0, slow0, acc0, delta0,
             nvals, w0a, w0b, h0a, h0b), mesh,
        out_lane_axes=(0, 0, 1), in_lane_axes=(1,) + (0,) * 12)
