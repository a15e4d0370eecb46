"""wvpk_torch's lane sharding (parallel/mesh.py) of the decode on CPU
meshes of two and three entries, against the port's unsharded path and
against wvpk's sharded path (its 8-device virtual CPU mesh): the decode
cases of tests/test_parallel.py and the dry run, with uneven lanes, plus a
mixed-chain bucket whose chain runs cross a shard boundary and a bucket of
fewer lanes than devices (the encode cases are in
test_torch_parallel_encode.py). Inputs are numpy, seeded from fixed numbers; integer codec, so
every comparison is exact."""

import numpy as np
import pytest
import torch

from wvpk.container import parse_blocks as jax_parse_blocks
from wvpk.engine.dsd_pipeline import finalize_dsd_group as \
    jax_finalize_dsd_group
from wvpk.engine.dsd_pipeline import launch_dsd_states as \
    jax_launch_dsd_states
from wvpk.engine.staging import group_blocks as jax_group_blocks
from wvpk.parallel import make_mesh as jax_make_mesh
from wvpk.parallel import sharded_decode_bucket as jax_sharded_decode_bucket
from wvpk.parallel import sharded_decode_states as jax_sharded_decode_states
from wvpk.testgen import EncodeSpec, encode_dsd_file, encode_file
from wvpk_torch.container import parse_blocks
from wvpk_torch.engine import decode_states
from wvpk_torch.engine.dsd_pipeline import fetch_list, \
    finalize_dsd_groups, launch_dsd_states
from wvpk_torch.engine.pipeline import _fetch_arrays, decode_tensors
from wvpk_torch.engine.staging import bucket_tensors, group_blocks
from wvpk_torch.ops.decorr_cuda import CHAINS, lane_runs
from wvpk_torch.parallel import make_mesh, shard_bucket, shard_ranges, \
    sharded_decode_bucket, sharded_decode_states
from wvpk_torch.parallel.dryrun import dryrun_multichip

MESHES = {"cpu2": ["cpu", "cpu"], "cpu3": ["cpu", "cpu", "cpu"]}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(8)


def noise(n, ch, scale, seed):
    return np.round(np.random.default_rng(seed).normal(0, scale, (n, ch))
                    ).astype(np.int64)


def test_make_mesh_takes_repeated_devices():
    assert make_mesh(devices=["cpu", "cpu"]) == [CPU, CPU]
    assert make_mesh(2, devices=["cpu"] * 3) == [CPU, CPU]
    with pytest.raises(ValueError):
        make_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    if not torch.cuda.is_available():
        # the default is every visible GPU: none here
        with pytest.raises(RuntimeError):
            make_mesh()


@pytest.mark.parametrize("L,n,want", [
    (7, 2, [(0, 4), (4, 7)]),
    (7, 3, [(0, 3), (3, 5), (5, 7)]),
    (2, 3, [(0, 1), (1, 2), None]),
    (6, 3, [(0, 2), (2, 4), (4, 6)]),
])
def test_shard_ranges_are_contiguous_and_uneven(L, n, want):
    assert shard_ranges(L, n) == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_dryrun_multichip(mesh):
    counts = dryrun_multichip(MESHES[mesh])
    n = len(MESHES[mesh])
    assert counts["lossless"] == 2 * n + 3
    assert counts["dsd_mode1"] == counts["dsd_mode3"] == n + 1
    assert counts["encode_lossy_float"] == n + 3


def _port_unsharded(b):
    out, crc, mute, crc_x, crc_wvc = decode_tensors(b, bucket_tensors(b, CPU))
    return (out.numpy(), crc.numpy(), mute.numpy(),
            None if crc_x is None else crc_x.numpy(),
            None if crc_wvc is None else crc_wvc.numpy())


def _same_lanes(b, got, want, where):
    """Two (out, crc, mute, crc_x, crc_wvc) results agree on every lane's
    samples and flags."""
    for i, st in enumerate(b.states):
        n = st.header.block_samples
        np.testing.assert_array_equal(got[0][:n, i], want[0][:n, i],
                                      err_msg=f"{where} lane {i}")
        assert int(got[1][i]) == int(want[1][i]), (where, i)
        assert bool(got[2][i]) == bool(want[2][i]), (where, i)
        if b.profile.has_wvx:
            assert int(got[3][i]) == int(want[3][i]), (where, i)
        if b.profile.has_wvc:
            assert int(got[4][i]) == int(want[4][i]), (where, i)


def _check_buckets(data, mesh, jax_mesh):
    """Every bucket of `data`: the port's sharded decode equals its
    unsharded one and wvpk's sharded one."""
    buckets = group_blocks([blk.state for blk in parse_blocks(data)])
    jax_buckets = jax_group_blocks([blk.state
                                    for blk in jax_parse_blocks(data)])
    assert len(buckets) == len(jax_buckets)
    for b, jb in zip(buckets, jax_buckets):
        got = sharded_decode_bucket(b, MESHES[mesh])
        assert got[0].shape[1] == len(b.states)
        _same_lanes(b, got, _port_unsharded(b), "port unsharded")
        _same_lanes(b, got, jax_sharded_decode_bucket(jb, jax_mesh), "wvpk")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_wvx_uneven_lanes(mesh, jax_mesh):
    """int32+wvx with lanes % devices != 0, a FALSE_STEREO bucket too."""
    rng = np.random.default_rng(21)
    stereo = np.clip(np.round(rng.normal(0, 1 << 24, (64 * 11, 2))),
                     -(1 << 30), 1 << 30).astype(np.int64)
    mono1 = np.clip(np.round(rng.normal(0, 1 << 22, (64 * 3, 1))),
                    -(1 << 30), 1 << 30).astype(np.int64)
    data = encode_file(stereo, EncodeSpec(
        block_samples=64, joint=True, bytes_stored=4, int32_mode="wvx",
        int32_sent_bits=4, int32_max_width=31))
    data += encode_file(mono1, EncodeSpec(
        block_samples=64, false_stereo=True, bytes_stored=4,
        int32_mode="wvx", int32_sent_bits=3))
    _check_buckets(data, mesh, jax_mesh)


HYBRID_FLOAT_DEEP = {
    "hybrid_balance": lambda rng: encode_file(
        np.stack([np.round(rng.normal(0, 8000, 64 * 9)),
                  np.round(rng.normal(0, 90, 64 * 9))],
                 axis=1).astype(np.int64),
        EncodeSpec(block_samples=64, hybrid=True, hybrid_bitrate=True,
                   hybrid_balance=True, bitrate=320, bitrate_delta=1)),
    "float": lambda rng: encode_file(
        np.clip(np.round(rng.normal(0, 1 << 20, (64 * 10, 2))),
                -(1 << 23) + 1, (1 << 23) - 1).astype(np.int64),
        EncodeSpec(block_samples=64, joint=True, float_data=True,
                   bytes_stored=4, float_shift=0, float_max_exp=130,
                   float_norm_exp=127)),
    "deep12": lambda rng: encode_file(
        np.clip(np.round(rng.normal(0, 60000, (64 * 13, 2))),
                -(1 << 23) + 1, (1 << 23) - 1).astype(np.int64),
        EncodeSpec(block_samples=64, joint=True, bytes_stored=3,
                   terms=(18, 18, 17, 17, 3, 2, 5, 1, 2, 18, 17, 2),
                   deltas=(2,) * 12)),
}


@pytest.mark.parametrize("family", sorted(HYBRID_FLOAT_DEEP))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_hybrid_float_deep(mesh, family, jax_mesh):
    data = HYBRID_FLOAT_DEEP[family](np.random.default_rng(22))
    _check_buckets(data, mesh, jax_mesh)


def _same_blocks(got, want, where):
    assert len(got) == len(want), where
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.samples, w.samples,
                                      err_msg=f"{where} block {k}")
        assert (g.crc, g.mute_error, g.crc_error) \
            == (w.crc, w.mute_error, w.crc_error), (where, k)


@pytest.mark.parametrize("mode", [1, 3])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_dsd_modes(mesh, mode, jax_mesh):
    """DSD modes 1 and 3 launched lane-sharded (launch_dsd_states with a
    mesh), uneven lanes: equal to the unsharded launch and to wvpk's
    sharded one."""
    d = np.random.default_rng(23).integers(0, 256, (64 * 11, 2))
    data = encode_dsd_file(d.astype(np.int64), mode, mono=False,
                           history_bits=2, block_samples=64)
    states = [blk.state for blk in parse_blocks(data)]
    jax_states = [blk.state for blk in jax_parse_blocks(data)]

    def run(m):
        launched = launch_dsd_states(states, CPU, m)
        out = [None] * len(states)
        for i, res in finalize_dsd_groups(
                launched, _fetch_arrays(fetch_list(launched))):
            out[i] = res
        return launched, out

    launched, got = run(make_mesh(devices=MESHES[mesh]))
    # one launch a shard, every shard on lanes of its own
    assert len(launched) == len(MESHES[mesh])
    assert sorted(i for ld in launched for i in ld.idxs) \
        == list(range(len(states)))
    _same_blocks(got, run(None)[1], "port unsharded")
    want = [None] * len(states)
    for ld in jax_launch_dsd_states(jax_states, mesh=jax_mesh):
        for i, res in zip(ld.idxs, jax_finalize_dsd_group(ld)):
            want[i] = res
    _same_blocks(got, want, "wvpk")


def _mixed_call():
    """wvpk's mixed PCM + DSD corpus of
    test_sharded_decode_states_matches_single_chip."""
    rng = np.random.default_rng(24)
    data = encode_file(
        np.round(rng.normal(0, 3000, (64 * 10, 2))).astype(np.int64),
        EncodeSpec(block_samples=64, joint=True))
    data += encode_file(
        np.round(rng.normal(0, 700, (64 * 3, 1))).astype(np.int64),
        EncodeSpec(block_samples=64, mono=True, terms=(17, 2),
                   deltas=(2, 2)))
    data += encode_file(
        np.stack([np.round(rng.normal(0, 8000, 64 * 4)),
                  np.round(rng.normal(0, 90, 64 * 4))],
                 axis=1).astype(np.int64),
        EncodeSpec(block_samples=64, hybrid=True, hybrid_bitrate=True,
                   hybrid_balance=True, bitrate=320, bitrate_delta=1))
    data += encode_file(
        np.clip(np.round(rng.normal(0, 1 << 20, (64 * 4, 2))),
                -(1 << 23) + 1, (1 << 23) - 1).astype(np.int64),
        EncodeSpec(block_samples=64, joint=True, float_data=True,
                   bytes_stored=4, float_shift=0, float_max_exp=130,
                   float_norm_exp=127))
    data += encode_dsd_file(
        rng.integers(0, 256, (64 * 5, 2)).astype(np.int64), 3, mono=False)
    return data


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_decode_states_matches_single_device(mesh, jax_mesh):
    data = _mixed_call()
    states = [blk.state for blk in parse_blocks(data)]
    got = sharded_decode_states(states, MESHES[mesh])
    _same_blocks(got, decode_states(states, "cpu"), "port unsharded")
    _same_blocks(got, jax_sharded_decode_states(
        [blk.state for blk in jax_parse_blocks(data)], jax_mesh), "wvpk")


# a bucket mixing term chains: three chains of CHAINS, each filling a
# segment (staging's _SEGMENT_MIN = 64 lanes), and a few lanes on a chain
# outside the table, which form the generic tail
MIX = (((18, 17, 2), (2, 2, 2), 70), ((17, 17), (2, 2), 66),
       ((18, 18, 2, 17, 3), (2,) * 5, 64), ((18, 2), (2, 1), 5))


def _mixed_chain_states():
    data = b"".join(encode_file(noise(32 * n, 2, 3000, 30 + k), EncodeSpec(
        block_samples=32, joint=True, terms=terms, deltas=deltas))
        for k, (terms, deltas, n) in enumerate(MIX))
    return data, [blk.state for blk in parse_blocks(data)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mixed_chain_bucket_split_across_shards(mesh, jax_mesh):
    """The chain runs of a mixed bucket cut to each shard's lanes and
    rebased to 0: every shard's runs tile its lanes, the runs of a chain
    that crosses a boundary go to both shards, every table chain runs its
    own kernel on some shard, and the results equal the unsharded and
    wvpk's."""
    data, states = _mixed_chain_states()
    (b,) = group_blocks(states)
    assert b.chain_segments is not None and len(b.chain_segments) == 4
    n = len(MESHES[mesh])
    ran = set()
    crossed = 0
    for r in shard_ranges(len(b.states), n):
        sub = shard_bucket(b, *r)
        L = r[1] - r[0]
        assert len(sub.states) == L == sub.words.shape[0]
        assert sub.indices == b.indices[r[0]:r[1]]
        segs = sub.chain_segments
        assert segs[0][1] == 0 and segs[-1][2] == L
        for (c, s, e, ntm), (c2, s2, _e2, _n2) in zip(segs, segs[1:]):
            assert e == s2
        for c, s, e, ntm in segs:
            nt = np.asarray([st.num_terms for st in sub.states[s:e]])
            assert ntm == (len(c) if c is not None else max(nt.max(), 1))
            assert all(c is None or tuple(st.terms[:st.num_terms]) == c
                       for st in sub.states[s:e])
        runs = lane_runs(L, False, sub.static_terms, segs)
        assert runs[0][1] == 0 and runs[-1][2] == L
        ran |= {cid for cid, _s, _e in runs}
        crossed += any(r[0] < s < r[1] for _c, s, _e, _n in b.chain_segments)
    table = {k for k, (_n, mono, terms) in enumerate(CHAINS) if not mono
             and terms in {t for t, _d, _n in MIX}}
    assert table <= ran and len(table) == 3
    assert crossed >= 1
    _check_buckets(data, mesh, jax_mesh)


def test_bucket_of_fewer_lanes_than_devices(jax_mesh):
    """Two lanes on three devices: the third shard is skipped, the lanes
    decode as unsharded."""
    data = encode_file(noise(128, 2, 3000, 40),
                       EncodeSpec(block_samples=64, joint=True))
    states = [blk.state for blk in parse_blocks(data)]
    (b,) = group_blocks(states)
    assert shard_ranges(len(b.states), 3)[2] is None
    _check_buckets(data, "cpu3", jax_mesh)
    _same_blocks(sharded_decode_states(states, ["cpu"] * 3),
                 decode_states(states, "cpu"), "unsharded")
