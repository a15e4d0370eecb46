"""wvpk_torch's CUDA kernels vs their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip. They import
no jax (the machine with the card has none), so run them without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Integer codec: every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from wvpk.container import parse_blocks
from wvpk.ref import decode_block
from wvpk.testgen import EncodeSpec, encode_file, encode_multichannel
from wvpk_torch.engine import decode_states
from wvpk_torch.engine.staging import bucket_tensors, group_blocks
from wvpk_torch.ops.decorr import decorr_post
from wvpk_torch.ops.decorr_cuda import decorr_post_cuda
from wvpk_torch.ops.entropy import entropy_decode
from wvpk_torch.ops.entropy_cuda import entropy_decode_cuda

pytestmark = pytest.mark.cuda

ALL_TERMS = [1, 2, 3, 4, 5, 6, 7, 8, 17, 18, -1, -2, -3]
MONO_TERMS = [1, 2, 3, 4, 5, 6, 7, 8, 17, 18]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "`python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py`")
    return torch.device("cuda")


def noise(n, ch, scale, seed):
    return np.round(np.random.default_rng(seed).normal(0, scale, (n, ch))
                    ).astype(np.int64)


def _zero_runs():
    pcm = np.zeros((512, 2), np.int64)
    pcm[100:130] = noise(30, 2, 50, 3)
    return encode_file(pcm, EncodeSpec(
        block_samples=256, joint=True,
        initial_medians=((0, 0, 0), (0, 0, 0))))


def _truncated():
    data = bytearray(encode_file(noise(512, 2, 2000, 5),
                                 EncodeSpec(block_samples=256, joint=True)))
    data[200:240] = b"\xff" * 40
    return bytes(data)


STREAMS = {
    "stereo_joint": lambda: encode_file(
        noise(700, 2, 3000, 1), EncodeSpec(block_samples=350, joint=True)),
    "mono": lambda: encode_file(
        noise(512, 1, 900, 2),
        EncodeSpec(block_samples=256, mono=True, terms=(18, 2),
                   deltas=(2, 1))),
    "zero_runs": _zero_runs,
    "limit_ones_escapes": lambda: encode_file(
        np.random.default_rng(4).integers(-2**22, 2**22, (256, 2)),
        EncodeSpec(block_samples=256, bytes_stored=4)),
    "truncated": _truncated,
    "cross_terms_24bit": lambda: encode_file(
        noise(600, 2, 20000, 3) << 3,
        EncodeSpec(block_samples=300, joint=True, bytes_stored=3, shift=3,
                   terms=(17, -1, 5, -2, 3, -3), deltas=(2, 3, 1, 2, 2, 4))),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_entropy_kernel_matches_plain(cuda, name):
    b = group_blocks([x.state for x in parse_blocks(STREAMS[name]())])[0]
    t = bucket_tensors(b, cuda)
    kw = dict(mono=b.profile.mono, nsteps=b.profile.nsteps)
    got = entropy_decode_cuda(t["words"], t["nwords_lane"], t["med"], **kw)
    want = entropy_decode(t["words"], t["nwords_lane"], t["med"], **kw)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def _decorr_inputs(seed, T, L, mono, big=False):
    rng = np.random.default_rng(seed)
    C = 1 if mono else 2
    rscale = 2**29 if big else 2**14
    res = rng.integers(-rscale, rscale, (T, L, C)).astype(np.int32)
    terms = np.zeros((L, 16), np.int32)
    deltas = np.zeros((L, 16), np.int32)
    num_terms = rng.integers(0, 17, L).astype(np.int32)
    pool = MONO_TERMS if mono else ALL_TERMS
    for i in range(L):
        terms[i, :num_terms[i]] = rng.choice(pool, num_terms[i])
        deltas[i, :num_terms[i]] = rng.integers(0, 8, num_terms[i])
    scale = 2**28 if big else 2**10
    wa = rng.integers(-scale, scale, (L, 16)).astype(np.int32)
    wb = rng.integers(-scale, scale, (L, 16)).astype(np.int32)
    hscale = 2**30 if big else 2**15
    ha = rng.integers(-hscale, hscale, (L, 16, 8)).astype(np.int64)
    hb = rng.integers(-hscale, hscale, (L, 16, 8)).astype(np.int64)
    ns = rng.integers(T // 2, T + 1, L).astype(np.int32)
    joint = rng.integers(0, 2, L).astype(bool)
    lim = np.where(rng.random(L) < 0.3, 2**13, 2**40).astype(np.int64)
    return (res, terms, deltas, wa, wb, ha, hb, num_terms, ns, joint, lim)


@pytest.mark.parametrize("mono,big", [(False, False), (True, False),
                                      (False, True)],
                         ids=["stereo", "mono", "stereo_wraparound"])
def test_decorr_kernel_matches_plain(cuda, mono, big):
    args = [torch.from_numpy(a).to(cuda)
            for a in _decorr_inputs(7, 96, 45, mono, big)]
    got = decorr_post_cuda(*args, mono=mono)
    want = decorr_post(*args, mono=mono)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def lossless_case(seed):
    """A random in-slice file (wvpk.testgen.fuzzspec: mono, false stereo,
    joint, 1-16 terms incl. cross terms, 8-32 bit, shift, int32
    zeros/ones/dups, block checksums), sometimes with a corrupted byte.
    Returns (data, pcm, spec)."""
    from wvpk.testgen.fuzzspec import random_pcm, random_spec

    rng = np.random.default_rng(2000 + seed)
    while True:
        spec = random_spec(rng, family=str(rng.choice(["plain", "int32"])))
        if not spec.hybrid and spec.int32_mode != "wvx":
            break
    n = int(rng.integers(spec.block_samples // 2,
                         spec.block_samples * 2 + 1))
    pcm = random_pcm(rng, n, spec.nch_data, spec)
    data = encode_file(pcm, spec)
    if rng.random() < 0.25:
        data = bytearray(data)
        data[int(rng.integers(64, len(data)))] ^= int(rng.integers(1, 256))
        data = bytes(data)
    return data, pcm, spec


def test_decode_states_cuda_matches_cpu_and_oracle(cuda):
    files = [STREAMS[n]() for n in sorted(STREAMS)]
    files.append(encode_multichannel(noise(600, 6, 3000, 6),
                                     EncodeSpec(block_samples=300,
                                                joint=True)))
    states = [b.state for f in files for b in parse_blocks(f)]
    got = decode_states(states, device=cuda)
    want = decode_states(states, device="cpu")
    for st, w, g in zip(states, want, got):
        np.testing.assert_array_equal(w.samples, g.samples)
        assert (w.crc, w.mute_error, w.crc_error) == \
            (g.crc, g.mute_error, g.crc_error)
        if not g.crc_error:
            np.testing.assert_array_equal(decode_block(st).samples,
                                          g.samples)


@pytest.mark.parametrize("seed", range(24))
def test_fuzz_lossless_cuda_matches_cpu(cuda, seed):
    """Random in-slice files: the kernels' decode equals the plain
    versions', flags included."""
    data, _pcm, spec = lossless_case(seed)
    states = [b.state for b in parse_blocks(data)]
    got = decode_states(states, device=cuda)
    want = decode_states(states, device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w.samples, g.samples,
                                      err_msg=f"seed {seed} {spec}")
        assert (w.crc, w.mute_error, w.crc_error) == \
            (g.crc, g.mute_error, g.crc_error), (seed, spec)
