"""wvpk_torch's device encoder sharded over CPU meshes of two and three
entries (parallel/mesh.py: sharded_encode_scans, sharded_invert_warm_state,
sharded_hybrid_encode_scan, through encode_blocks_device and encode_device
with `mesh=`), against the port's unsharded encode and wvpk's sharded one
(its 8-device virtual CPU mesh): the encode cases of tests/test_parallel.py,
with uneven lane counts. The references are made once for both meshes.
Inputs are numpy, seeded from fixed numbers; the blocks must be equal byte
for byte."""

import functools

import numpy as np
import pytest

from wvpk.encode import build_spec as jax_build_spec
from wvpk.encode import encode_device as jax_encode_device
from wvpk.engine.device_encoder import \
    encode_blocks_device as jax_encode_blocks_device
from wvpk.parallel import make_mesh as jax_make_mesh
from wvpk_torch.container import parse_blocks
from wvpk_torch.encode import build_spec, encode_device
from wvpk_torch.engine import decode_states
from wvpk_torch.engine.device_encoder import encode_blocks_device

MESHES = {"cpu2": ["cpu", "cpu"], "cpu3": ["cpu", "cpu", "cpu"]}


def _sine_pcm(nblocks, bs, seed, period=83.0, scale=4000, noise_sd=100):
    rng = np.random.default_rng(seed)
    t = np.arange(nblocks * bs)
    s = scale * np.sin(2 * np.pi * t / period)
    return np.round(np.stack([s, s * 0.6], 1)
                    + rng.normal(0, noise_sd, (t.size, 2))).astype(np.int64)


@functools.cache
def _references(case, warmup, kw):
    """(the port's unsharded blocks, wvpk's sharded blocks) of an encode
    case, made once for both meshes."""
    pcm, kw = CASES[case](), dict(kw)
    return (encode_blocks_device(pcm, build_spec(pcm, **kw), warmup,
                                 device="cpu"),
            jax_encode_blocks_device(pcm, jax_build_spec(pcm, **kw),
                                     mesh=jax_make_mesh(8), warmup=warmup))


def _encodes(case, mesh, warmup=0, **kw):
    """(port sharded, port unsharded, wvpk sharded) blocks of one spec."""
    pcm = CASES[case]()
    return (encode_blocks_device(pcm, build_spec(pcm, **kw), warmup,
                                 mesh=MESHES[mesh]),
            *_references(case, warmup, tuple(sorted(kw.items()))))


CASES = {
    "sine11": lambda: _sine_pcm(11, 300, 7),
    "wvx": lambda: (np.random.default_rng(17).integers(
        -(1 << 30), 1 << 30, (5 * 300, 2)) | 1).astype(np.int64),
    "hybrid": lambda: _sine_pcm(5, 256, 11, period=61.0, scale=6000,
                                noise_sd=300),
    "warm": lambda: _sine_pcm(7, 300, 23, period=97.0, scale=5000,
                              noise_sd=200),
}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_device_encode(mesh):
    got, plain, want = _encodes("sine11", mesh, block_samples=300)
    assert got == plain == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_device_encode_wvx(mesh):
    pcm = CASES["wvx"]()
    got, plain, want = _encodes("wvx", mesh, bytes_per_sample=4,
                                block_samples=300)
    assert got == plain == want
    res = decode_states([b.state for b in parse_blocks(b"".join(got))],
                        "cpu")
    assert not any(r.crc_error or r.mute_error for r in res)
    np.testing.assert_array_equal(
        np.concatenate([r.samples for r in res]), pcm)


def _public_pcm(ch):
    rng = np.random.default_rng(13)
    t = np.arange(9 * 200)[:, None]
    return np.round(3000 * np.sin(2 * np.pi * t / 71.0)
                    + rng.normal(0, 90, (t.size, ch))).astype(np.int64)


def _warm5_pcm():
    rng = np.random.default_rng(23)
    return np.round(3000 * np.sin(2 * np.pi * np.arange(3 * 200) / 71.0)
                    [:, None] + rng.normal(0, 90, (600, 5))).astype(np.int64)


@functools.cache
def _public_references(case, warmup):
    """(the port's unsharded stream, wvpk's sharded stream) of a public
    encode_device case, made once for both meshes."""
    pcm = _warm5_pcm() if case == "warm5" else _public_pcm(case)
    return (encode_device(pcm, block_samples=200, device="cpu",
                          warmup=warmup),
            jax_encode_device(pcm, block_samples=200, mesh=jax_make_mesh(8),
                              warmup=warmup))


@pytest.mark.parametrize("ch", [2, 5])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_public_encode_device_mesh(mesh, ch):
    got = encode_device(_public_pcm(ch), block_samples=200,
                        mesh=MESHES[mesh], warmup=0)
    assert (got, got) == _public_references(ch, 0)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_device_encode_hybrid(mesh):
    got, plain, want = _encodes("hybrid", mesh, block_samples=256,
                                hybrid=True, bitrate=384)
    assert got == plain == want


@pytest.mark.parametrize("hybrid", [False, True], ids=["lossless", "hybrid"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_device_encode_warmup(mesh, hybrid):
    """Warm seeding under a mesh: the lookahead scan shards
    (sharded_invert_warm_state), and the blocks are the unsharded warm
    path's and wvpk's."""
    kw = dict(hybrid=True, bitrate=384) if hybrid else {}
    got, plain, want = _encodes("warm", mesh, warmup=512,
                                block_samples=300, **kw)
    assert got == plain == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_public_encode_device_mesh_warm_multichannel(mesh):
    """The default warm seeding rides the mesh too, on a >2ch segment."""
    got = encode_device(_warm5_pcm(), block_samples=200, mesh=MESHES[mesh])
    assert (got, got) == _public_references("warm5", 512)
