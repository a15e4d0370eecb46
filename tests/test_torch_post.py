"""wvpk_torch's plain fixup (float arm, hybrid clip), wvx injection and
fixed-point log2/exp2 vs wvpk's, on the same random inputs (numpy,
seeded). Integer codec: every comparison is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

from wvpk.ops.bitio import exp2s_v as jax_exp2s_v
from wvpk.ops.bitio import mylog2_v as jax_mylog2_v
from wvpk.ops.post import fixup as jax_fixup
from wvpk.ops.post import wvx_inject as jax_wvx_inject
from wvpk_torch.ops.bitio import exp2s_v, mylog2_v
from wvpk_torch.ops.post import fixup, wvx_inject
from wvpk_torch.ops.post_select import wvx_inject_any
from wvpk_torch.ops.wvx_cuda import wvx_inject_cuda

from test_torch_cuda import wvx_inputs


def tt(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_float_arm_matches_xla():
    """FloatUtils.cs:32-56: shifts of both signs, 0, and the +/-32 ends
    of the host clamp (C#'s mod-32 shift makes 32 a no-op), then the
    24-bit clip."""
    T, L = 40, 9
    rng = np.random.default_rng(1)
    out = rng.integers(-2**23, 2**23, (T, L, 2)).astype(np.int32)
    out[0, :, 0] = [2**31 - 1, -2**31, 0, 1, -1, 2**23, -2**23 - 1, 5, -5]
    fsh = np.asarray([-32, -31, -5, -1, 0, 3, 10, 31, 32], np.int32)
    shift, bs = np.zeros(L, np.int32), np.full(L, 3, np.int32)
    zod = np.zeros((L, 3), np.int32)
    want = jax_fixup(out, shift, bs, fsh, zod, is_float=True,
                     int32_expand=False, hybrid=False)
    got = fixup(*tt(out, shift, bs, fsh, zod), is_float=True,
                int32_expand=False, hybrid=False)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("bytes_stored", [0, 1, 2, 3])
def test_hybrid_clip_matches_xla(bytes_stored):
    """The hybrid clip to the stored width (UnpackUtils.cs:1350-1393),
    with shifts, on values past both ends of the range."""
    T, L = 48, 8
    rng = np.random.default_rng(10 + bytes_stored)
    lim = 1 << (8 * (bytes_stored + 1) - 1)
    out = rng.integers(-2 * lim, 2 * lim, (T, L, 2)).clip(
        -2**31, 2**31 - 1).astype(np.int32)
    shift = np.asarray([0, 1, 3, 7, 0, 2, 5, 0], np.int32)
    bs = np.full(L, bytes_stored, np.int32)
    fsh = np.zeros(L, np.int32)
    zod = np.tile(np.asarray([2, 0, 0], np.int32), (L, 1))
    for expand in (False, True):
        want = jax_fixup(out, shift, bs, fsh, zod, is_float=False,
                         int32_expand=expand, hybrid=True)
        got = fixup(*tt(out, shift, bs, fsh, zod), is_float=False,
                    int32_expand=expand, hybrid=True)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("C", [1, 2], ids=["mono_false_stereo", "stereo"])
def test_wvx_inject_matches_xla(C):
    """Random sent_bits 0-8, old-style and max_width streams, every
    re-expansion arm, short lanes; the mono case has FALSE_STEREO lanes
    (the second pass over zeros)."""
    (out, ns, words, sbit, sbc, sent, mw, zod, fs) = wvx_inputs(5, 48, 12, C)
    fs_arg = fs if fs.any() else None
    want = jax_wvx_inject(out, ns, words.view(np.uint32), sbit, sbc, sent,
                          mw, zod, false_stereo=fs_arg)
    got = wvx_inject(*tt(out, ns, words, sbit, sbc, sent, mw, zod),
                     None if fs_arg is None else torch.from_numpy(fs))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert (C == 2) or fs.any()
    same = wvx_inject_any(*tt(out, ns, words, sbit, sbc, sent, mw, zod),
                          None if fs_arg is None else torch.from_numpy(fs))
    for w, g in zip(got, same):
        assert torch.equal(w, g)


def test_wvx_kernel_wrapper_refuses_cpu_tensors():
    arrays = tt(*wvx_inputs(6, 8, 2, 2))
    with pytest.raises(ValueError, match="CUDA"):
        wvx_inject_cuda(*arrays)


def test_exp2s_mylog2_match_xla():
    """Over the whole table index range at every shift that matters, and
    at the edges: exp2s' int32 wrap past shift 9 and the 9-bit window of
    mylog2 on both sides of 2^9."""
    logs = np.concatenate([np.arange(-64 * 256, 64 * 256),
                           [2**31 - 1, -(2**31), 2**40, -(2**40)]])
    want = np.asarray(jax_exp2s_v(logs.astype(np.int64)))
    got = exp2s_v(torch.from_numpy(logs.astype(np.int64))).numpy()
    np.testing.assert_array_equal(want, got)
    vals = np.concatenate([np.arange(0, 1 << 17),
                           [(1 << k) + d for k in range(17, 61)
                            for d in (-1, 0, 1)]]).astype(np.int64)
    want = np.asarray(jax_mylog2_v(vals))
    got = mylog2_v(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(want, got)
