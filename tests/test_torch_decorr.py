"""wvpk_torch's plain decorrelation, post and pack steps vs wvpk's: the XLA
functions and the Pallas decorr kernel in interpret mode with fold_post,
on the same random inputs (numpy, seeded). Integer codec: every
comparison is exact (tolerance 0)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from wvpk.ops.decorr import decorr_decode as jax_decorr_decode
from wvpk.ops.decorr_pallas import decorr_decode_pallas
from wvpk.ops.decorr_select import decorr_post_any as jax_decorr_post_any
from wvpk.ops.pack import pack_samples as jax_pack_samples
from wvpk.ops.post import fixup as jax_fixup
from wvpk.ops.post import joint_mute_crc as jax_joint_mute_crc
from wvpk_torch.ops import decorr_cuda
from wvpk_torch.ops.decorr import decorr_decode, decorr_post
from wvpk_torch.ops.decorr_cuda import CHAINS, GENERIC, decorr_post_cuda, \
    lane_runs
from wvpk_torch.ops.decorr_select import decorr_post_any, \
    decorr_post_wvc_any
from wvpk_torch.ops.pack import pack_samples
from wvpk_torch.ops.post import fixup, joint_mute_crc

ALL_TERMS = [1, 2, 3, 4, 5, 6, 7, 8, 17, 18, -1, -2, -3]
MONO_TERMS = [1, 2, 3, 4, 5, 6, 7, 8, 17, 18]


def rand_inputs(seed, T, L, mono, big=False, max_terms=16):
    """Residuals and per-lane decorrelation state with mixed chains of
    every term class (mono chains take no cross-channel terms)."""
    rng = np.random.default_rng(seed)
    C = 1 if mono else 2
    rscale = 2**29 if big else 2**14
    res = rng.integers(-rscale, rscale, (T, L, C)).astype(np.int32)
    terms = np.zeros((L, 16), np.int32)
    deltas = np.zeros((L, 16), np.int32)
    num_terms = rng.integers(0, max_terms + 1, L).astype(np.int32)
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
    return res, terms, deltas, wa, wb, ha, hb, num_terms


def post_inputs(seed, T, L):
    """nsamples (some short lanes), joint flags and mute limits (some low
    enough to fire mid-block)."""
    rng = np.random.default_rng(seed + 1000)
    ns = rng.integers(T // 2, T + 1, L).astype(np.int32)
    ns[0] = T
    joint = rng.integers(0, 2, L).astype(bool)
    lim = np.where(rng.random(L) < 0.3, 2**13, 2**40).astype(np.int64)
    return ns, joint, lim


def tt(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


DECORR_CASES = {
    "stereo_all_terms": dict(seed=1, T=96, L=9, mono=False),
    "mono_all_terms": dict(seed=2, T=96, L=7, mono=True),
    "stereo_wraparound": dict(seed=3, T=64, L=8, mono=False, big=True),
    "stereo_short_chains": dict(seed=4, T=80, L=12, mono=False, max_terms=3),
}


@pytest.mark.parametrize("name", sorted(DECORR_CASES))
def test_decorr_matches_xla(name):
    kw = DECORR_CASES[name]
    args = rand_inputs(**kw)
    want = np.asarray(jax_decorr_decode(*args, mono=kw["mono"]))
    got = decorr_decode(*tt(*args), mono=kw["mono"]).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
def test_decorr_post_matches_pallas_fold_post(mono):
    """The plain version of the CUDA kernel against the Pallas kernel it
    replaces, both with the joint/mute/CRC step folded in."""
    T, L = 72, 10
    args = rand_inputs(5 + mono, T, L, mono)
    ns, joint, lim = post_inputs(5, T, L)
    w_out, w_crc, w_fb = decorr_decode_pallas(
        *args, mono=mono, num_terms_max=int(args[-1].max()),
        interpret=True, fold_post_args=(ns, joint, lim))
    out, crc, fb = decorr_post(*tt(*args, ns, joint, lim), mono=mono)
    np.testing.assert_array_equal(np.asarray(w_crc), crc.numpy())
    np.testing.assert_array_equal(np.asarray(w_fb), fb.numpy())
    valid = np.arange(T)[:, None] < ns[None, :]
    np.testing.assert_array_equal(
        np.where(valid[..., None], np.asarray(w_out), 0), out.numpy())
    assert (fb.numpy() < ns).any() and (fb.numpy() == ns).any()


@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
def test_joint_mute_crc_matches_xla(mono):
    T, L = 64, 11
    C = 1 if mono else 2
    rng = np.random.default_rng(7 + mono)
    dec = rng.integers(-2**15, 2**15, (T, L, C)).astype(np.int32)
    dec[5, 3, 0] = -2**31                  # C# unchecked abs stays negative
    ns, joint, lim = post_inputs(7, T, L)
    broke = np.zeros(L, bool)
    broke[4] = True
    want = jax_joint_mute_crc(dec, ns, joint, lim, broke, mono=mono)
    got = joint_mute_crc(*tt(dec, ns, joint, lim, broke), mono=mono)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert got[2].numpy().any() and not got[2].numpy().all()


def test_decorr_select_matches_xla_pair():
    """decorr_post_any on CPU == wvpk's decorr_decode + joint_mute_crc."""
    T, L = 48, 9
    args = rand_inputs(9, T, L, False)
    ns, joint, lim = post_inputs(9, T, L)
    broke = np.arange(L) == 2
    dec = jax_decorr_decode(*args, mono=False)
    want = jax_joint_mute_crc(dec, ns, joint, lim, broke, mono=False)
    got = decorr_post_any(*tt(*args, ns, joint, lim, broke), mono=False)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


FIXUP_ZOD = {"shift_only": (0, 0, 0), "zeros": (5, 0, 0),
             "ones": (0, 3, 0), "dups": (0, 0, 2)}


@pytest.mark.parametrize("arm", sorted(FIXUP_ZOD))
def test_fixup_integer_arms_match_xla(arm):
    T, L = 32, 6
    rng = np.random.default_rng(11)
    out = rng.integers(-2**20, 2**20, (T, L, 2)).astype(np.int32)
    shift = rng.integers(0, 12, L).astype(np.int32)
    zod = np.tile(np.asarray(FIXUP_ZOD[arm], np.int32), (L, 1))
    expand = arm != "shift_only"
    bs, fsh = np.ones(L, np.int32), np.zeros(L, np.int32)
    want = jax_fixup(out, shift, bs, fsh, zod, is_float=False,
                     int32_expand=expand, hybrid=False)
    got = fixup(*tt(out, shift, bs, fsh, zod), is_float=False,
                int32_expand=expand, hybrid=False)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("bps", [1, 2, 3, 4])
def test_pack_matches_xla(bps):
    rng = np.random.default_rng(bps)
    T, L, C = 64, 3, 2
    lo, hi = -(1 << (bps * 8 - 1)), 1 << (bps * 8 - 1)
    samples = rng.integers(lo, hi, size=(T, L, C)).astype(np.int32)
    want = np.asarray(jax_pack_samples(samples, bps=bps)).view(np.int32)
    got = pack_samples(torch.from_numpy(samples), bps=bps).numpy()
    np.testing.assert_array_equal(want, got)


def test_kernel_wrapper_refuses_cpu_tensors():
    args = tt(*rand_inputs(1, 8, 2, False), *post_inputs(1, 8, 2))
    with pytest.raises(ValueError, match="CUDA"):
        decorr_post_cuda(*args, mono=False)


def chain_inputs(seed, T, L, chain, mono):
    """rand_inputs with every lane on `chain` (num_terms its length)."""
    res, terms, deltas, wa, wb, ha, hb, nt = rand_inputs(seed, T, L, mono)
    terms[:] = 0
    terms[:, :len(chain)] = chain
    deltas[:, len(chain):] = 0
    nt[:] = len(chain)
    return res, terms, deltas, wa, wb, ha, hb, nt


@pytest.mark.parametrize("name", [name for name, _m, _t in CHAINS])
def test_decorr_post_matches_pallas_static_terms(name):
    """Lanes of one chain of the CUDA kernels' table: the plain version
    against wvpk's Pallas kernel specialised to the chain (static_terms,
    fold_post, interpret mode), and decorr_post_any given the chain
    (the plain path computes the same function whatever it is told)."""
    (mono, chain), = [(m, t) for n, m, t in CHAINS if n == name]
    T, L = 40, 6
    args = chain_inputs(60 + len(name), T, L, chain, mono)
    ns, joint, lim = post_inputs(60, T, L)
    w_out, w_crc, w_fb = decorr_decode_pallas(
        *args, mono=mono, num_terms_max=len(chain), interpret=True,
        static_terms=chain, fold_post_args=(ns, joint, lim))
    out, crc, fb = decorr_post(*tt(*args, ns, joint, lim), mono=mono)
    np.testing.assert_array_equal(np.asarray(w_crc), crc.numpy())
    np.testing.assert_array_equal(np.asarray(w_fb), fb.numpy())
    valid = np.arange(T)[:, None] < ns[None, :]
    np.testing.assert_array_equal(
        np.where(valid[..., None], np.asarray(w_out), 0), out.numpy())
    broke = np.zeros(L, bool)
    plain = decorr_post_any(*tt(*args, ns, joint, lim, broke), mono=mono)
    told = decorr_post_any(*tt(*args, ns, joint, lim, broke), mono=mono,
                           static_terms=chain)
    for a, b in zip(plain, told):
        assert torch.equal(a, b)


def _segmented_inputs(seed, T, mono):
    """Lanes in runs of two table chains and a mixed tail, with the
    chain_segments staging gives such a bucket."""
    a, b = [t for _n, m, t in CHAINS if m == mono][:2]
    parts = [chain_inputs(seed, T, 4, a, mono),
             chain_inputs(seed + 1, T, 3, b, mono),
             rand_inputs(seed + 2, T, 5, mono)]
    args = [np.concatenate([p[i] for p in parts], axis=1 if i == 0 else 0)
            for i in range(8)]
    tail = max(int(args[-1][7:].max()), 1)
    return args, ((a, 0, 4, len(a)), (b, 4, 7, len(b)), (None, 7, 12, tail))


@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
def test_decorr_post_any_chain_segments_agree(mono):
    """decorr_post_any and its wvc arm with and without chain_segments on
    a segmented bucket: the same results, equal to wvpk's decorr_post_any
    given the same segments."""
    T = 48
    args, segs = _segmented_inputs(70 + mono, T, mono)
    L = args[0].shape[1]
    ns, joint, lim = post_inputs(70, T, L)
    broke = np.arange(L) == 3
    inputs = tt(*args, ns, joint, lim, broke)
    plain = decorr_post_any(*inputs, mono=mono)
    seg = decorr_post_any(*inputs, mono=mono, chain_segments=segs)
    want = jax_decorr_post_any(*args, ns, joint, lim, broke, mono=mono,
                               num_terms_max=None, chain_segments=segs)
    for a, b, w in zip(plain, seg, want):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(np.asarray(w), b.numpy())
    corr = tt(np.random.default_rng(71).integers(
        -300, 300, args[0].shape).astype(np.int32))[0]
    wvc = [inputs[0], corr] + inputs[1:]
    for a, b in zip(decorr_post_wvc_any(*wvc, mono=mono),
                    decorr_post_wvc_any(*wvc, mono=mono,
                                        chain_segments=segs)):
        assert torch.equal(a, b)


def test_chain_table_matches_cuda_source():
    """ops/decorr_cuda.py::CHAINS names the instantiations of the
    WVPK_CHAIN lines of csrc/decorr_pass.cuh's WVPK_CHAIN_TABLE, then of
    its WVPK_DECODE_CHAIN_TABLE: the same ids, channel counts and terms,
    in the same order, ENCODE_CHAINS the first table's; the sources that
    compile a kernel per chain (decorr.cu, encode_hybrid.cu,
    encode_invert.cu) expand the first table and hold no list of their
    own, and decorr.cu alone expands the second."""
    csrc = Path(decorr_cuda.__file__).parents[1] / "csrc"
    pat = r"^\s*WVPK_CHAIN\((\d+), (true|false), ([-\d, ]+)\)"
    header = (csrc / "decorr_pass.cuh").read_text()
    lines = re.findall(pat, header, re.M)
    got = [(int(i), m == "true", tuple(int(t) for t in terms.split(",")))
           for i, m, terms in lines]
    assert got == [(k, m, t) for k, (_n, m, t) in enumerate(CHAINS)]
    shared = header[:header.index("#define WVPK_DECODE_CHAIN_TABLE")]
    assert len(re.findall(pat, shared, re.M)) == len(
        decorr_cuda.ENCODE_CHAINS)
    for name in ("decorr.cu", "encode_hybrid.cu", "encode_invert.cu"):
        src = (csrc / name).read_text()
        assert re.search(r"^\s*WVPK_CHAIN_TABLE$", src, re.M), name
        assert not re.findall(pat, src, re.M), name
        assert bool(re.search(r"^\s*WVPK_DECODE_CHAIN_TABLE$", src,
                              re.M)) == (name == "decorr.cu"), name


LANE_RUNS = {
    "static_terms": (dict(static_terms=(18, 17, 2)), False, [(0, 0, 10)]),
    "static_mono": (dict(static_terms=(18, 17, 2)), True, [(4, 0, 10)]),
    "static_outside": (dict(static_terms=(5, 1)), False, [(GENERIC, 0, 10)]),
    "mono_cross_terms": (dict(static_terms=(18, -1)), True,
                         [(GENERIC, 0, 10)]),
    "none": ({}, False, [(GENERIC, 0, 10)]),
    "segments": (dict(chain_segments=(((17, 17), 0, 3, 2),
                                      ((5, 1), 3, 6, 2),
                                      (None, 6, 10, 4))), False,
                 [(1, 0, 3), (GENERIC, 3, 10)]),
    "static_wins": (dict(static_terms=(17, 17),
                         chain_segments=(((17, 17), 0, 10, 2),)), False,
                    [(1, 0, 10)]),
}


@pytest.mark.parametrize("name", sorted(LANE_RUNS))
def test_lane_runs(name):
    """The kernel runs a call launches: the chain's compiled kernel where
    CHAINS has it (mono chains by their own ids), the generic kernel
    otherwise, adjacent generic runs merged."""
    kw, mono, want = LANE_RUNS[name]
    assert lane_runs(10, mono, **kw) == want


def test_lane_runs_must_tile_the_bucket():
    with pytest.raises(ValueError, match="tile"):
        lane_runs(10, False, chain_segments=(((17, 17), 0, 4, 2),
                                             (None, 5, 10, 3)))
