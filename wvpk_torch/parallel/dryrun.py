"""Multi-device dry run: one real sharded step for every codec family,
checked block for block against the scalar oracle (the port's analog of
wvpk's `__graft_entry__.dryrun_multichip`).

    python -m wvpk_torch.parallel.dryrun [device ...]

runs it on the given devices (every visible GPU by default; repeats
allowed, e.g. `cpu cpu` or `cuda:0 cuda:0`).
"""

from __future__ import annotations

import io
import sys

import numpy as np


def _mixed_corpus(n_devices: int):
    """One .wv byte string per PCM family (block counts chosen so that
    lanes % devices != 0) and the DSD mode 1 and 3 files: wvpk's dry-run
    corpus, made with the port's testgen from the same seed, the DSD files
    cut into blocks of 64 byte-samples so that their lanes are uneven too
    (wvpk's are one block each)."""
    from ..testgen import EncodeSpec, encode_dsd_file, encode_file

    rng = np.random.default_rng(1)
    bs = 64

    def pcm(n, ch, scale):
        return np.round(rng.normal(0, scale, (n, ch))).astype(np.int64)

    nb = n_devices * 2 + 3          # uneven lane count
    fams = {
        "lossless": encode_file(
            pcm(bs * nb, 2, 3000),
            EncodeSpec(block_samples=bs, joint=True)),
        "mono": encode_file(
            pcm(bs * (n_devices + 1), 1, 900),
            EncodeSpec(block_samples=bs, mono=True, terms=(17, 2),
                       deltas=(2, 2))),
        "hybrid_balance": encode_file(
            np.stack([np.round(rng.normal(0, 9000, bs * nb)),
                      np.round(rng.normal(0, 80, bs * nb))],
                     axis=1).astype(np.int64),
            EncodeSpec(block_samples=bs, joint=False, hybrid=True,
                       hybrid_bitrate=True, hybrid_balance=True,
                       bitrate=300, bitrate_delta=1)),
        "float": encode_file(
            np.clip(pcm(bs * (n_devices + 2), 2, 1 << 20),
                    -(1 << 23) + 1, (1 << 23) - 1),
            EncodeSpec(block_samples=bs, joint=True, float_data=True,
                       bytes_stored=4, float_shift=0, float_max_exp=130,
                       float_norm_exp=127)),
        "int32_wvx": encode_file(
            np.clip(pcm(bs * nb, 2, 1 << 24), -(1 << 30), 1 << 30),
            EncodeSpec(block_samples=bs, joint=True, bytes_stored=4,
                       int32_mode="wvx", int32_sent_bits=5,
                       int32_max_width=31)),
        "deep12": encode_file(
            pcm(bs * (n_devices + 3), 2, 60000),
            EncodeSpec(block_samples=bs, joint=True, bytes_stored=3,
                       terms=(18, 18, 17, 17, 3, 2, 5, 1, 2, 18, 17, 2),
                       deltas=(2,) * 12)),
    }
    dsd = {
        f"dsd_mode{m}": encode_dsd_file(
            rng.integers(0, 256, (bs * (n_devices + 1), 2)).astype(np.int64),
            m, mono=False, history_bits=2, block_samples=bs)
        for m in (1, 3)
    }
    return fams, dsd


def _check_bucket(fam, b, mesh) -> int:
    """sharded_decode_bucket on one bucket, every lane against the
    oracle. Returns the lanes checked."""
    from .. import consts
    from ..ref import decode_block
    from .mesh import sharded_decode_bucket

    out, crc, mute, crc_x, crc_wvc = sharded_decode_bucket(b, mesh)
    for i, st in enumerate(b.states):
        want = decode_block(st)
        got = out[:st.header.block_samples, i, :]
        if st.flags & consts.FALSE_STEREO:
            got = np.repeat(got, 2, axis=1)
        np.testing.assert_array_equal(got, want.samples,
                                      err_msg=f"{fam} lane {i}")
        if int(crc[i]) != want.crc or mute[i]:
            raise AssertionError(f"{fam} lane {i}: crc or mute")
        if b.profile.has_wvx and int(crc_x[i]) != want.crc_x:
            raise AssertionError(f"{fam} lane {i}: crc_x")
        if b.profile.has_wvc and int(crc_wvc[i]) != want.crc_wvc:
            raise AssertionError(f"{fam} lane {i}: crc_wvc")
    return len(b.states)


def _decode_clean(blocks) -> list:
    from ..ref import decode_block

    outs = [decode_block(blk.state) for blk in blocks]
    if any(r.crc_error or r.mute_error for r in outs):
        raise AssertionError("an encoded block decodes with an error")
    return outs


def dryrun_multichip(devices) -> dict:
    """Shard the whole decode over `devices` (parallel.make_mesh; repeats
    allowed) on every codec path (lossless, hybrid with HYBRID_BALANCE,
    float, int32+wvx, 12-term chains, mono, DSD modes 1 and 3, hybrid +
    .wvc) and the device encoder (lossless with warm seeding, hybrid, wvx,
    float, lossy float), with uneven lane counts, at tiny shapes: every
    decoded block bit-exact against the scalar oracle, every sharded
    encode byte-identical to the unsharded one on the mesh's first device
    and decoding back to its source. Returns the blocks checked per part
    and raises on the first mismatch."""
    from .. import api, consts
    from ..container import parse_blocks
    from ..container.blocks import pair_wvc
    from ..encode import build_spec, encode, encode_device
    from ..engine.device_encoder import encode_blocks_device
    from ..engine.dsd_pipeline import fetch_list, finalize_dsd_groups, \
        launch_dsd_states
    from ..engine.pipeline import _fetch_arrays
    from ..engine.staging import group_blocks
    from ..ref import decode_block
    from .mesh import make_mesh

    mesh = make_mesh(devices=devices)
    n = len(mesh)
    dev = mesh[0]
    counts = {}
    fams, dsd = _mixed_corpus(n)
    for fam, data in fams.items():
        states = [blk.state for blk in parse_blocks(data)]
        counts[fam] = sum(_check_bucket(fam, b, mesh)
                          for b in group_blocks(states))
    for fam, data in dsd.items():
        states = [blk.state for blk in parse_blocks(data)]
        launched = launch_dsd_states(states, dev, mesh)
        for i, res in finalize_dsd_groups(
                launched, _fetch_arrays(fetch_list(launched))):
            want = decode_block(states[i])
            np.testing.assert_array_equal(res.samples, want.samples,
                                          err_msg=f"{fam} block {i}")
            if res.crc_error:
                raise AssertionError(f"{fam} block {i}: crc")
        counts[fam] = len(states)
    # hybrid-lossless: a paired correction stream decodes exactly under
    # the sharded wvc program, with the exact CRC checked
    rngw = np.random.default_rng(5)
    nwb = n + 3                         # uneven lane count
    wsrc = np.round(2500 * np.sin(np.arange(64 * nwb) / 9.0)[:, None]
                    + rngw.normal(0, 500, (64 * nwb, 2))).astype(np.int32)
    wv_b, wvc_b = encode(wsrc, hybrid=True, bitrate=400, wvc=True,
                         block_samples=64)
    wblocks = parse_blocks(wv_b)
    if pair_wvc(wblocks, wvc_b) != len(wblocks):
        raise AssertionError("wvc: a block left unpaired")
    counts["hybrid_wvc"] = 0
    for b in group_blocks([blk.state for blk in wblocks]):
        if not b.profile.has_wvc:
            raise AssertionError("wvc: a bucket without its corrections")
        counts["hybrid_wvc"] += _check_bucket("hybrid_wvc", b, mesh)
    # the device encoder over the same mesh: the sharded blocks are the
    # unsharded call's, and decode back to the source
    rng = np.random.default_rng(3)
    t = np.arange((n + 3) * 64)         # uneven lane count
    sig = 900 * np.sin(2 * np.pi * t / 37.0)
    pcm = np.round(np.stack([sig, sig * 0.6], 1)
                   + rng.normal(0, 40, (t.size, 2))).astype(np.int64)

    def same_as_unsharded(p, spec, warmup=0):
        blocks = encode_blocks_device(p, spec, warmup, mesh=mesh)
        if blocks != encode_blocks_device(p, spec, warmup, device=dev):
            raise AssertionError("a sharded encode differs from unsharded")
        return blocks

    enc = same_as_unsharded(pcm, build_spec(pcm, block_samples=64), 48)
    outs = _decode_clean(parse_blocks(b"".join(enc)))
    np.testing.assert_array_equal(
        np.concatenate([r.samples for r in outs]), pcm)
    counts["encode_lossless_warm"] = len(enc)
    henc = same_as_unsharded(pcm * 4, build_spec(
        pcm * 4, block_samples=64, hybrid=True, bitrate=384))
    _decode_clean(parse_blocks(b"".join(henc)))
    counts["encode_hybrid"] = len(henc)
    wpcm = (np.round(pcm * 131072).astype(np.int64) | 1)
    wspec = build_spec(wpcm, bytes_per_sample=4, block_samples=64)
    if wspec.int32_mode != "wvx":
        raise AssertionError("the wide encode is not routed to wvx")
    wenc = same_as_unsharded(wpcm, wspec)
    outs = _decode_clean(parse_blocks(b"".join(wenc)))
    np.testing.assert_array_equal(
        np.concatenate([r.samples for r in outs]), wpcm)
    counts["encode_wvx"] = len(wenc)
    fpcm = (pcm.astype(np.float64) * 2.0 ** -15).astype(np.float32)
    fouts = _decode_clean(parse_blocks(
        encode_device(fpcm, block_samples=64, mesh=mesh)))
    fspec = build_spec(fpcm)
    fdec = (np.concatenate([r.samples for r in fouts]).astype(np.float64)
            * 2.0 ** (fspec.float_norm_exp - 150)).astype(np.float32)
    np.testing.assert_array_equal(fdec.view(np.uint32), fpcm.view(np.uint32))
    counts["encode_float"] = len(fouts)
    # lossy float: off-grid content, sharded == unsharded, the decode
    # within half a grid step, the stream stamped lossy
    opcm = rng.normal(0, 0.3, pcm.shape).astype(np.float32)
    lenc = encode_device(opcm, block_samples=64, mesh=mesh, float_lossy=True)
    if lenc != encode_device(opcm, block_samples=64, device=dev,
                             float_lossy=True):
        raise AssertionError("the sharded lossy-float encode differs")
    lblocks = parse_blocks(lenc)
    louts = _decode_clean(lblocks)
    ne = lblocks[0].state.float_norm_exp
    lrest = (np.concatenate([r.samples for r in louts]).astype(np.float64)
             * 2.0 ** (ne - 150))
    if np.abs(lrest.reshape(opcm.shape) - opcm).max() > 2.0 ** (ne - 151):
        raise AssertionError("lossy float: error past half a grid step")
    if api.WavpackGetMode(api.WavpackOpenFileInput(
            io.BytesIO(lenc), device=dev)) & consts.MODE_LOSSLESS:
        raise AssertionError("lossy float: stream stamped lossless")
    counts["encode_lossy_float"] = len(louts)
    return counts


if __name__ == "__main__":
    got = dryrun_multichip(sys.argv[1:] or None)
    print(f"dryrun_multichip: {sum(got.values())} blocks bit-exact: {got}")
