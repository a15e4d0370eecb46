"""wvpk_torch's plain entropy decoder vs wvpk's (XLA scan and Pallas kernel
in interpret mode), on the same staged buckets. Integer codec: every
comparison is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

from wvpk.container import parse_blocks
from wvpk.engine.staging import group_blocks
from wvpk.ops.entropy import entropy_decode as jax_entropy_decode
from wvpk.ops.entropy_pallas import entropy_decode_pallas
from wvpk.testgen import EncodeSpec, encode_file
from wvpk_torch.engine.staging import bucket_tensors
from wvpk_torch.ops.entropy import entropy_decode
from wvpk_torch.ops.entropy_cuda import entropy_decode_cuda
from wvpk_torch.ops.entropy_select import entropy_decode_any

CPU = torch.device("cpu")


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
    # a run of 0xff bytes inside the first block's payload reads as more
    # than LIMIT_ONES ones: the lane breaks as at the end of its stream
    data = bytearray(encode_file(noise(512, 2, 2000, 5),
                                 EncodeSpec(block_samples=256, joint=True)))
    data[200:240] = b"\xff" * 40
    return bytes(data)


CASES = {
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
}


def _bucket(name):
    return group_blocks([b.state for b in parse_blocks(CASES[name]())])[0]


def _port(b):
    t = bucket_tensors(b, CPU)
    res, broke, ndec = entropy_decode(
        t["words"], t["nwords_lane"], t["med"], mono=b.profile.mono,
        nsteps=b.profile.nsteps)
    return res.numpy(), broke.numpy(), ndec.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_entropy_matches_xla(name):
    b = _bucket(name)
    prof = b.profile
    want = jax_entropy_decode(
        b.words, b.nwords_lane, b.med, b.slow, b.acc, b.delta,
        mono=prof.mono, hybrid=False, hybrid_bitrate=False,
        hybrid_balance=False, nsteps=prof.nsteps)
    got = _port(b)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g)
    if name == "truncated":
        assert got[1].tolist() == [True, False] and got[2][0] < 512
    if name == "zero_runs":
        assert (got[0] == 0).mean() > 0.5


@pytest.mark.parametrize("name", sorted(CASES))
def test_entropy_matches_pallas_interpret(name):
    b = _bucket(name)
    want = entropy_decode_pallas(
        b.words.astype(np.uint32), b.nwords_lane, b.med,
        mono=b.profile.mono, nsteps=b.profile.nsteps, interpret=True)
    for w, g in zip(want, _port(b)):
        np.testing.assert_array_equal(np.asarray(w), g)


def test_dispatch_takes_plain_on_cpu():
    b = _bucket("stereo_joint")
    t = bucket_tensors(b, CPU)
    got = entropy_decode_any(t["words"], t["nwords_lane"], t["med"],
                             mono=False, nsteps=b.profile.nsteps)
    want = _port(b)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g.numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    b = _bucket("mono")
    t = bucket_tensors(b, CPU)
    with pytest.raises(ValueError, match="CUDA"):
        entropy_decode_cuda(t["words"], t["nwords_lane"], t["med"],
                            mono=True, nsteps=b.profile.nsteps)
