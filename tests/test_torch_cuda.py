"""wvpk_torch's CUDA kernels vs their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip. They import
no jax (the machine with the card has none) and make, parse and check
their inputs with the port's own testgen, container and ref, so run them
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Integer codec: every comparison is exact (tolerance 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

from wvpk_torch.container import parse_blocks
from wvpk_torch.container.blocks import pair_wvc
from wvpk_torch.engine import decode_states
from wvpk_torch.engine.dsd_pipeline import group_dsd, group_tensors
from wvpk_torch.engine.staging import bucket_tensors, group_blocks
from wvpk_torch.ops.dsd import dsd_fast_decode_bytes, dsd_high_decode_bytes
from wvpk_torch.ops.dsd_cuda import dsd_fast_decode_cuda, \
    dsd_high_decode_cuda, int64_lanes
from wvpk_torch.ops.decorr import Pack, decorr_post, decorr_post_packed, \
    decorr_post_wvc
from wvpk_torch.ops.decorr_cuda import CHAINS, ENCODE_CHAINS, \
    cluster_sms, decorr_post_cuda, decorr_post_wvc_cuda
from wvpk_torch.ops.decorr_select import decorr_packed_any, \
    decorr_post_any, decorr_post_wvc_any
from wvpk_torch.ops.entropy import entropy_decode, wvc_corrections
from wvpk_torch.ops.entropy_cuda import entropy_decode_cuda, \
    entropy_decode_wvc_cuda
from wvpk_torch.ops.pack import pack_samples
from wvpk_torch.ops.post import fixup, mask_muted, wvx_inject
from wvpk_torch.ops.wvc_cuda import wvc_corrections_cuda
from wvpk_torch.ops.wvx_cuda import int64_lanes as wvx_int64_lanes
from wvpk_torch.ops.wvx_cuda import wvx_inject_cuda
from wvpk_torch.ref import decode_block
from wvpk_torch.testgen import EncodeSpec, encode_dsd_file, encode_file, \
    encode_multichannel
from wvpk_torch.testgen.edge import DSD_EDGE_PROFILES, EDGE_PROFILES, \
    ENCODE_EDGE_CHAIN, ENCODE_EDGE_KINDS, WVC_CUT_EVERY, dsd_edge_states, \
    encode_edge_lanes, edge_states, wvc_edge_lanes, wvc_min_bits, \
    wvx_edge_lanes
from wvpk_torch.testgen.encoder import encode_blocks

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


def _zero_runs(**hybrid):
    pcm = np.zeros((512, 2), np.int64)
    pcm[100:130] = noise(30, 2, 50, 3)
    return encode_file(pcm, EncodeSpec(
        block_samples=256, joint=True,
        initial_medians=((0, 0, 0), (0, 0, 0)), **hybrid))


def _truncated(**hybrid):
    data = bytearray(encode_file(noise(512, 2, 2000, 5),
                                 EncodeSpec(block_samples=256, joint=True,
                                            **hybrid)))
    data[200:240] = b"\xff" * 40
    return bytes(data)


HYB = dict(hybrid=True, hybrid_bitrate=True, bitrate=400, bitrate_delta=1)

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
    "hybrid_bitrate_balance": lambda: encode_file(
        noise(900, 2, 3000, 6),
        EncodeSpec(block_samples=300, joint=True, hybrid=True,
                   hybrid_bitrate=True, hybrid_balance=True, bitrate=350,
                   bitrate_delta=2)),
    "hybrid_plain": lambda: encode_file(
        noise(600, 2, 7000, 8),
        EncodeSpec(block_samples=300, joint=True, hybrid=True, bitrate=600)),
    "hybrid_mono": lambda: encode_file(
        noise(600, 1, 3000, 9),
        EncodeSpec(block_samples=300, mono=True, **HYB)),
    "hybrid_zero_runs": lambda: _zero_runs(**HYB),
    "hybrid_truncated": lambda: _truncated(**HYB),
}


def _wvc_pair(pcm, spec):
    """Parsed blocks of a hybrid file with its correction file paired."""
    sink = []
    blocks = parse_blocks(b"".join(encode_blocks(pcm, spec, wvc_sink=sink)))
    pair_wvc(blocks, b"".join(sink))
    return blocks


WVC_PAIRS = {
    "stereo_bitrate_balance": lambda: _wvc_pair(
        noise(900, 2, 3000, 11),
        EncodeSpec(block_samples=300, joint=True, hybrid=True,
                   hybrid_bitrate=True, hybrid_balance=True, bitrate=300,
                   bitrate_delta=2, wvc=True)),
    "mono": lambda: _wvc_pair(
        noise(600, 1, 2000, 12),
        EncodeSpec(block_samples=300, mono=True, wvc=True, **HYB)),
    "stereo_cross_terms": lambda: _wvc_pair(
        noise(600, 2, 5000, 13),
        EncodeSpec(block_samples=300, hybrid=True, bitrate=500, wvc=True,
                   terms=(17, -3, 2), deltas=(2, 2, 2))),
}


def _kw(prof):
    return dict(mono=prof.mono, nsteps=prof.nsteps, hybrid=prof.hybrid,
                hybrid_bitrate=prof.hybrid_bitrate,
                hybrid_balance=prof.hybrid_balance)


def _entropy_args(t):
    return (t["words"], t["nwords_lane"], t["med"], t["slow"], t["acc"],
            t["delta"])


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_entropy_kernel_matches_plain(cuda, name):
    b = group_blocks([x.state for x in parse_blocks(STREAMS[name]())])[0]
    t = bucket_tensors(b, cuda)
    got = entropy_decode_cuda(*_entropy_args(t), **_kw(b.profile))
    want = entropy_decode(*_entropy_args(t), **_kw(b.profile))
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("name", sorted(WVC_PAIRS))
def test_entropy_wvc_and_corrections_kernels_match_plain(cuda, name):
    b = group_blocks([x.state for x in WVC_PAIRS[name]()])[0]
    assert b.profile.has_wvc
    t = bucket_tensors(b, cuda)
    kw = _kw(b.profile)
    del kw["hybrid"]
    got = entropy_decode_wvc_cuda(*_entropy_args(t), **kw)
    want = entropy_decode(*_entropy_args(t), hybrid=True, wvc=True, **kw)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert (want[1] > 0).any()
    res, mc, base = want[:3]
    corr = wvc_corrections_cuda(t["wvc_words"], mc, base, res)
    assert torch.equal(corr, wvc_corrections(t["wvc_words"], mc, base, res))


@pytest.mark.parametrize("profile", ["wvc", "wvc_mono"])
def test_wvc_kernel_edge_streams_match_plain(cuda, profile):
    """The wvc profiles' 64 edge streams (testgen/edge.py::edge_states,
    the lanes whose .wvc is cut short among them): the entropy kernel's
    wvc outputs through the correction kernel, exact against the plain
    scan; every cut lane's codes need more bits than its .wvc holds, so
    its cursor runs past its stream into the row's fill."""
    (b,) = group_blocks(edge_states(profile, 64, seed=3))
    t = bucket_tensors(b, cuda)
    kw = _kw(b.profile)
    del kw["hybrid"]
    res, mc, base, _broke, _ndec = entropy_decode_wvc_cuda(
        *_entropy_args(t), **kw)
    got = wvc_corrections_cuda(t["wvc_words"], mc, base, res)
    want = wvc_corrections(t["wvc_words"], mc, base, res)
    torch.cuda.synchronize()
    assert torch.equal(want, got)
    bits = np.asarray([8 * len(st.wvcbits) for st in b.states])
    cut = np.arange(len(bits)) % WVC_CUT_EVERY == 0
    assert (wvc_min_bits(mc.cpu().numpy())[cut] > bits[cut]).all()


def test_wvc_wrapper_refuses(cuda):
    """What the correction kernel cannot take raises before a launch: rows
    of 2^26 words or more (its 32-bit bit cursor), three channels, rows of
    fewer than 2 words, CPU tensors."""
    def launch(W, C=2, T=4, dev=cuda):
        words = torch.zeros((1, W), dtype=torch.int32, device=dev)
        vals = torch.zeros((T, 1, C), dtype=torch.int32, device=dev)
        return wvc_corrections_cuda(words, vals, vals, vals)

    launches = wvc_corrections_cuda.launches
    for case, match in (((1 << 26,), "32-bit"), ((8, 3), "channels"),
                        ((1,), "shape"),
                        ((8, 2, 4, torch.device("cpu")), "CUDA")):
        with pytest.raises(ValueError, match=match):
            launch(*case)
    assert wvc_corrections_cuda.launches == launches
    launch((1 << 26) - 64, C=1, T=1)
    torch.cuda.synchronize()
    assert wvc_corrections_cuda.launches == launches + 1


@pytest.mark.parametrize("seed", [21, 22])
@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
def test_wvc_kernel_edge_lanes_match_plain(cuda, mono, seed):
    """The correction scan's 64 edge lanes (testgen/edge.py::
    wvc_edge_lanes: maxcodes of every bit length 0-31 and negative, codes
    on both sides of extras, bit length 31's forced extra bit, negative
    residuals, base + code past int32, rows read past their last word's
    start) through the kernel, exact against the plain scan."""
    args = _on(cuda, *wvc_edge_lanes(64, seed=seed, mono=mono))
    got = wvc_corrections_cuda(*args)
    want = wvc_corrections(*args)
    torch.cuda.synchronize()
    assert torch.equal(want, got)


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


DECORR = {"stereo": (False, False), "mono": (True, False),
          "stereo_wraparound": (False, True)}


@pytest.mark.parametrize("name", sorted(DECORR))
def test_decorr_kernel_matches_plain(cuda, name):
    mono, big = DECORR[name]
    args = [torch.from_numpy(a).to(cuda)
            for a in _decorr_inputs(7, 96, 45, mono, big)]
    got = decorr_post_cuda(*args, mono=mono)
    want = decorr_post(*args, mono=mono)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("name", sorted(DECORR))
def test_decorr_wvc_kernel_matches_plain(cuda, name):
    mono, big = DECORR[name]
    args = [torch.from_numpy(a).to(cuda)
            for a in _decorr_inputs(8, 96, 45, mono, big)]
    rng = np.random.default_rng(9)
    corr = rng.integers(-2**12, 2**12, tuple(args[0].shape))
    corr = np.where(rng.random(corr.shape) < 0.5, 0, corr).astype(np.int32)
    args.insert(1, torch.from_numpy(corr).to(cuda))
    got = decorr_post_wvc_cuda(*args, mono=mono)
    want = decorr_post_wvc(*args, mono=mono)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert not torch.equal(want[1], want[2])


@pytest.mark.parametrize("profile", sorted(EDGE_PROFILES))
def test_entropy_kernel_edge_streams_match_plain(cuda, profile):
    """64 lanes of edge streams per profile (testgen/edge.py: words of 2
    to 30 bits across the bit reader's refills, zero runs, LIMIT_ONES
    escapes, truncated, corrupted and zero-filled payloads, the longest
    lanes ending in the row's tail): residuals, intervals, broke and ndec
    equal to the plain version's."""
    (b,) = group_blocks(edge_states(profile, 64, seed=3))
    t = bucket_tensors(b, cuda)
    kw = _kw(b.profile)
    if b.profile.has_wvc:
        del kw["hybrid"]
        got = entropy_decode_wvc_cuda(*_entropy_args(t), **kw)
        want = entropy_decode(*_entropy_args(t), hybrid=True, wvc=True, **kw)
    else:
        got = entropy_decode_cuda(*_entropy_args(t), **kw)
        want = entropy_decode(*_entropy_args(t), **kw)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    broke = want[-2]
    assert broke.any() and not broke.all()


def _chain_lanes(seed, T, L, chain, mono):
    """_decorr_inputs with every lane on `chain`."""
    arrays = list(_decorr_inputs(seed, T, L, mono))
    arrays[1][:] = 0
    arrays[1][:, :len(chain)] = chain
    arrays[2][:, len(chain):] = 0
    arrays[7][:] = len(chain)
    return arrays


@pytest.mark.parametrize("wvc", [False, True], ids=["plain", "wvc"])
@pytest.mark.parametrize("name", [name for name, _m, _t in CHAINS])
def test_decorr_chain_kernel_matches_plain(cuda, name, wvc):
    """Each compiled chain, stereo and mono, with and without the wvc arm:
    200 steps (several staged tiles, lanes ending mid-tile), 45 lanes,
    against the plain version; the chain's own kernel ran."""
    (mono, chain), = [(m, c) for n, m, c in CHAINS if n == name]
    args = [torch.from_numpy(a).to(cuda)
            for a in _chain_lanes(20 + len(name), 200, 45, chain, mono)]
    cuda_fn, plain = ((decorr_post_wvc_cuda, decorr_post_wvc) if wvc
                      else (decorr_post_cuda, decorr_post))
    if wvc:
        corr = np.random.default_rng(21).integers(
            -2**12, 2**12, tuple(args[0].shape)).astype(np.int32)
        args.insert(1, torch.from_numpy(corr).to(cuda))
    before = cuda_fn.chain_launches[name]
    got = cuda_fn(*args, mono=mono, static_terms=chain)
    want = plain(*args, mono=mono)
    torch.cuda.synchronize()
    assert cuda_fn.chain_launches[name] == before + 1
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
def test_decorr_mixed_bucket_segments_match_plain(cuda, mono):
    """A mixed-chain bucket through decorr_post_any and its wvc arm with
    its chain_segments: a run of each table chain of its channel count,
    one of a chain outside the table and a mixed tail (both generic),
    every run's kernel overlapping on side streams; equal to the plain
    version on the CPU."""
    T = 150
    runs = [c for _n, m, c in CHAINS if m == mono] + [(3, 17, 2)]
    parts = [_chain_lanes(30 + k, T, 20 + k, c, mono)
             for k, c in enumerate(runs)]
    parts.append(list(_decorr_inputs(39, T, 25, mono)))
    arrays = [np.concatenate([p[i] for p in parts], axis=1 if i == 0 else 0)
              for i in range(len(parts[0]))]
    segs, pos = [], 0
    for c, p in zip(runs + [None], parts):
        n = p[0].shape[1]
        segs.append((c, pos, pos + n, 16 if c is None else len(c)))
        pos += n
    broke = np.zeros(pos, bool)
    broke[5] = True
    arrays.append(broke)
    corr = np.random.default_rng(40).integers(
        -2**12, 2**12, arrays[0].shape).astype(np.int32)
    on_cpu = [torch.from_numpy(a) for a in arrays]
    on_card = [a.to(cuda) for a in on_cpu]
    got = decorr_post_any(*on_card, mono=mono, chain_segments=tuple(segs))
    want = decorr_post_any(*on_cpu, mono=mono)
    for w, g in zip(want, got):
        assert torch.equal(w, g.cpu())
    c_cpu, c_card = torch.from_numpy(corr), torch.from_numpy(corr).to(cuda)
    got = decorr_post_wvc_any(on_card[0], c_card, *on_card[1:], mono=mono,
                              chain_segments=tuple(segs))
    want = decorr_post_wvc_any(on_cpu[0], c_cpu, *on_cpu[1:], mono=mono)
    for w, g in zip(want, got):
        assert torch.equal(w, g.cpu())


def _packed_lanes(seed, T, L, mono, bps, hybrid, chain=None):
    """_decorr_inputs (or _chain_lanes on `chain`) for the packed store:
    sample counts 0, 1, 37 and T on the first lanes, the rest between T / 2
    and T; a tenth of the lanes broke, shifts 0-5 (0-2 lossless), every
    lane storing bps - 1 bytes. The random chains take the samples past
    every stored width, so a hybrid lane clips."""
    arrays = (_chain_lanes(seed, T, L, chain, mono) if chain is not None
              else list(_decorr_inputs(seed, T, L, mono)))
    arrays[8][:4] = (0, 1, 37, T)
    rng = np.random.default_rng(seed + 1)
    broke = rng.random(L) < 0.1
    shift = rng.integers(0, 6 if hybrid else 3, L).astype(np.int32)
    bs = np.full(L, bps - 1, np.int32)
    return arrays, broke, shift, bs


PACKED = [(bps, mono, hybrid) for bps in (1, 2, 3) for mono in (False, True)
          for hybrid in (False, True)]


# steps a lane of the packed-store tests: 200 (a ragged last tile), or
# a count off every multiple of 8 that T C bps allows (16-, 8- and 4-byte
# aligned rows)
RAGGED_STEPS = {(False, 1): 202, (False, 2): 203, (False, 3): 202,
                (True, 1): 204, (True, 2): 202, (True, 3): 204}


@pytest.mark.parametrize("steps", ["200", "ragged"])
@pytest.mark.parametrize("kernel", ["generic", "chain", "very_high"])
@pytest.mark.parametrize("bps,mono,hybrid", PACKED,
                         ids=[f"bps{b}-{'mono' if m else 'stereo'}-"
                              f"{'hybrid' if h else 'lossless'}"
                              for b, m, h in PACKED])
def test_decorr_packed_store_matches_plain_chain(cuda, bps, mono, hybrid,
                                                 kernel, steps):
    """The kernels' packed store against the plain chain on the same
    decorrelation output (the unpacked store's): pack_samples(fixup(
    mask_muted(...))), byte for byte over the whole (L, W) payload, pad
    past each lane's sample count and muted rows included; 45 lanes, 200
    steps (a ragged last tile) or RAGGED_STEPS, lanes muted by `broke` and
    by the mute
    limit, sample counts 0, 1 and 37; the generic kernel on random chains,
    the `default` chain's kernel and the very high chain's cluster
    kernel; CRC and first_bad as the unpacked store's."""
    chain = None
    kw = {}
    if kernel != "generic":
        prefix = "default" if kernel == "chain" else "very_high"
        chain = [c for n, m, c in CHAINS
                 if m == mono and n.startswith(prefix)][0]
        kw["static_terms"] = chain
    T = 200 if steps == "200" else RAGGED_STEPS[mono, bps]
    arrays, broke, shift, bs = _packed_lanes(50 + bps, T, 45, mono, bps,
                                             hybrid, chain)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    bs = torch.from_numpy(bs).to(cuda)
    pack = Pack(*(torch.from_numpy(a).to(cuda) for a in (broke, shift)),
                bps, hybrid)
    out, crc, first_bad = decorr_post_cuda(*args, mono=mono, **kw)
    masked, mute = mask_muted(out, args[8], pack.broke, first_bad)
    want = pack_samples(fixup(masked, pack.shift, bs, None,
                              None, is_float=False, int32_expand=False,
                              hybrid=hybrid), bps=bps)
    before = decorr_post_cuda.launches
    got = decorr_post_cuda(*args, mono=mono, pack=pack, **kw)
    torch.cuda.synchronize()
    assert decorr_post_cuda.launches == before + 1
    assert torch.equal(got[0], want)
    assert torch.equal(got[1], crc) and torch.equal(got[2], first_bad)
    n_muted = int(mute.sum())
    assert 0 < n_muted < 45 and (first_bad < args[8]).any() \
        and bool(pack.broke.any())
    if hybrid:      # the clip engaged
        unclipped = fixup(masked, pack.shift, bs, None, None,
                          is_float=False, int32_expand=False, hybrid=False)
        assert not torch.equal(pack_samples(unclipped, bps=bps), want)


def test_decorr_very_high_library_bucket_matches_generic(cuda):
    """The very high chain's cluster kernel at the library cell's bucket
    shape, 1,925 stereo lanes staged at 65,536 steps, 44,100 samples a
    lane (libwavpack's block for -hh at 44.1 kHz) but for a few short and
    empty lanes, both stores: equal to the
    generic kernel on the same lanes (the plain version takes minutes at
    this size; the tests above hold both kernels to it on small buckets),
    payload, CRC and first_bad, each kernel's launch counted."""
    name = "very_high"
    (chain,) = [c for n, _m, c in CHAINS if n == name]
    T, L = 65536, 1925
    arrays, broke, shift, _bs = _packed_lanes(90, T, L, False, 2, False,
                                              chain)
    arrays[8][4:] = 44100
    arrays[8][L - 3:] = (0, 1, 44099)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    pack = Pack(*(torch.from_numpy(a).to(cuda) for a in (broke, shift)), 2,
                False)
    fn = decorr_post_cuda
    for kw in ({}, {"pack": pack}):
        before = dict(fn.chain_launches)
        got = fn(*args, mono=False, static_terms=chain, **kw)
        want = fn(*args, mono=False, **kw)
        torch.cuda.synchronize()
        assert fn.chain_launches[name] == before[name] + 1
        assert fn.chain_launches["generic"] == before["generic"] + 1
        for w, g in zip(want, got):
            assert torch.equal(w, g)
        del got, want


CLUSTER_STORES = [(mono, store) for mono in (False, True)
                  for store in ("packed", "unpacked", "wvc")]
CLUSTER_IDS = [f"{'mono' if m else 'stereo'}-{st}" for m, st in CLUSTER_STORES]


def _cluster_case(cuda, mono, store, seed, T, L):
    """The very high chain of `mono`'s channel count on L lanes of T
    steps through the cluster kernel and the plain version, compared
    output for output: sample counts 0, 1, 37 and T on the first lanes,
    the rest between T / 2 and T; a tenth of the lanes broke, about a
    third with a mute limit that fires; the packed store at 2 bytes a
    sample, the (T, L, C) store, or the wvc arm."""
    name = "very_high_mono" if mono else "very_high"
    (chain,) = [c for n, _m, c in CHAINS if n == name]
    arrays, broke, shift, _bs = _packed_lanes(seed, T, L, mono, 2, False,
                                              chain)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    kw = {}
    fn, plain = decorr_post_cuda, decorr_post
    if store == "wvc":
        corr = np.random.default_rng(seed + 2).integers(
            -2**12, 2**12, tuple(args[0].shape)).astype(np.int32)
        args.insert(1, torch.from_numpy(corr).to(cuda))
        fn, plain = decorr_post_wvc_cuda, decorr_post_wvc
    elif store == "packed":
        kw["pack"] = Pack(*(torch.from_numpy(a).to(cuda)
                            for a in (broke, shift)), 2, False)
        plain = decorr_post_packed
    before = fn.chain_launches[name]
    got = fn(*args, mono=mono, static_terms=chain, **kw)
    want = plain(*args, mono=mono, **kw)
    torch.cuda.synchronize()
    assert fn.chain_launches[name] == before + 1
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    first_bad = want[-1]
    assert (first_bad < args[-3]).any()        # a lane muted by its limit


@pytest.mark.parametrize("mono,store", CLUSTER_STORES, ids=CLUSTER_IDS)
def test_decorr_cluster_kernel_ragged_lanes_match_plain(cuda, mono, store):
    """The very high chains' cluster kernel on 300 lanes (9 warps and 12
    lanes: a cluster's last CTAs with a part-filled warp and two empty
    ones) of 202 steps (lanes ending mid-tile, sample counts 0 and 1,
    muted lanes), each store, equal to the plain version."""
    _cluster_case(cuda, mono, store, 110 + len(store), 202, 300)


@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
def test_decorr_cluster_kernel_more_clusters_than_a_wave(cuda, mono):
    """More clusters than the card holds at once (4,500 lanes: 36
    clusters of four CTAs, one CTA an SM, 132 SMs), packed store, equal to
    the plain version: the later clusters wait for SMs and still pipe
    their tiles through."""
    _cluster_case(cuda, mono, "packed", 120, 100, 4500)


@pytest.mark.parametrize("lanes", [1925, 2640])
@pytest.mark.parametrize("mono,wvc", [(False, False), (True, False),
                                      (False, True)],
                         ids=["stereo", "mono", "stereo-wvc"])
def test_decorr_cluster_ctas_on_sms_of_their_own(cuda, lanes, mono, wvc):
    """At the very high library cell's lane counts (1,925-2,640 a call), a
    launch in the cluster kernel's shape (its CTAs, threads and dynamic
    shared memory) has every CTA resident at once, each on an SM no other
    CTA of the launch shares (%smid), clusters of four."""
    sm, seen = cluster_sms(lanes, mono, cuda, wvc=wvc)
    sm = sm.cpu().tolist()
    assert len(sm) == (lanes + 127) // 128 * 4
    assert bool(seen.all()), seen.cpu().tolist()
    assert -1 not in sm and len(set(sm)) == len(sm), sm


def _very_high_file(seed, n=2048, block=512):
    """A stereo stream on the very high chain (16 terms, deltas 2) whose
    second block has equal channels, written mono on the mono chain
    (FALSE_STEREO), as `wavpack` writes it. Returns (bytes, pcm)."""
    terms = {n_: t for n_, _m, t in CHAINS}
    pcm = noise(n, 2, 3000, seed)
    pcm[block:2 * block, 1] = pcm[block:2 * block, 0]
    out = []
    for name, lo, hi in (("very_high", 0, block),
                         ("very_high_mono", block, 2 * block),
                         ("very_high", 2 * block, n)):
        fs = name.endswith("mono")
        spec = EncodeSpec(block_samples=block, joint=not fs, false_stereo=fs,
                          terms=terms[name], deltas=(2,) * len(terms[name]),
                          total_samples_override=n)
        out += encode_blocks(pcm[lo:hi, :1] if fs else pcm[lo:hi], spec,
                             start_sample=lo, first=lo == 0, last=hi >= n)
    return b"".join(out), pcm


def test_decode_counts_chain_and_generic_lanes(cuda):
    """decode_states on the card of 24 very high streams (72 stereo
    lanes, a run of the stereo bucket long enough for a chain segment, and
    24 mono lanes: the very high chains' kernels) and of a stream on a
    chain outside the table (4 lanes in the same stereo bucket: the
    generic kernel): every file equal to its source, launch#chain_lanes +
    launch#generic_lanes = launch#lanes, each lane counted by the kernel
    that ran it, which the wrapper's launch counts confirm."""
    from wvpk_torch import trace

    files = [_very_high_file(80 + k) for k in range(24)]
    pcm = noise(2048, 2, 3000, 84)
    files.append((encode_file(pcm, EncodeSpec(block_samples=512, joint=True,
                                              terms=(3, 17, 2),
                                              deltas=(2, 2, 2))), pcm))
    states, pcms = [], []
    for data, p in files:
        states += [b.state for b in parse_blocks(data)]
        pcms.append(p)
    fn = decorr_post_cuda
    before = dict(fn.chain_launches)
    with trace.collect() as sink:
        got = decode_states(states, "cuda")
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in fn.chain_launches.items()
           if v > before[k]}
    assert set(ran) == {"very_high", "very_high_mono", "generic"}, ran
    assert sink["launch#lanes"] == len(states) == 100
    assert sink["launch#chain_lanes"] == 96
    assert sink["launch#generic_lanes"] == 4
    assert sink["launch#chain_lanes"] + sink["launch#generic_lanes"] \
        == sink["launch#lanes"]
    for k, p in enumerate(pcms):
        blocks = got[4 * k:4 * k + 4]
        assert not any(b.crc_error or b.mute_error for b in blocks)
        np.testing.assert_array_equal(
            np.concatenate([b.samples for b in blocks]), p)


@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
def test_decorr_packed_mixed_bucket_on_side_streams(cuda, mono):
    """A mixed-chain bucket's packed store: each table chain's run and the
    generic kernel's two runs (a chain outside the table, a mixed tail) on
    side streams, through decorr_packed_any, equal to the plain chain on
    the CPU (decorr.decorr_post_packed)."""
    T, bps = 150, 2
    runs = [c for _n, m, c in CHAINS if m == mono] + [(3, 17, 2)]
    parts = [_chain_lanes(60 + k, T, 20 + k, c, mono)
             for k, c in enumerate(runs)]
    parts.append(list(_decorr_inputs(69, T, 25, mono)))
    arrays = [np.concatenate([p[i] for p in parts], axis=1 if i == 0 else 0)
              for i in range(len(parts[0]))]
    segs, pos = [], 0
    for c, p in zip(runs + [None], parts):
        n = p[0].shape[1]
        segs.append((c, pos, pos + n, 16 if c is None else len(c)))
        pos += n
    rng = np.random.default_rng(70)
    broke = rng.random(pos) < 0.05
    shift = rng.integers(0, 3, pos).astype(np.int32)
    arrays += [broke, shift]
    on_cpu = [torch.from_numpy(a) for a in arrays]
    on_card = [a.to(cuda) for a in on_cpu]
    kw = dict(mono=mono, hybrid=False, bps=bps)
    got = decorr_packed_any(*on_card, chain_segments=tuple(segs), **kw)
    want = decorr_packed_any(*on_cpu, **kw)
    for w, g in zip(want, got):
        assert torch.equal(w, g.cpu())


def _packed_corpus():
    from test_torch_packed_store import CORPUS, DELIVERED, _states

    return CORPUS, DELIVERED, _states


def _cpu_delivery(b):
    """The chain the bucket's payload took before the packed store, on the
    CPU: decode_tensors' samples through fused.deliver's pack_samples."""
    from wvpk_torch.engine import pipeline
    from wvpk_torch.engine.fused import deliver

    t = bucket_tensors(b, torch.device("cpu"))
    out, crc, mute, crc_x, crc_wvc = pipeline.decode_tensors(b, t)
    return deliver(out, crc, mute, pipeline.delivery_bps(b), crc_x=crc_x,
                   crc_wvc=crc_wvc)


@pytest.mark.parametrize("name", sorted(_packed_corpus()[0]))
def test_packed_delivery_on_the_card_equals_the_cpu(cuda, name):
    """Each corpus of tests/test_torch_packed_store.py (8-, 16- and 24-bit,
    mono and stereo, lossless and hybrid with the clip engaged, damaged
    lanes that mute, and the float, int32, wvx and wvc buckets that keep
    the unpacked store) delivered on the card, unsharded and as the shards of a mesh
    that repeats the card: every payload word and CRC/mute row equal to
    the CPU's chain before the packed store. A bucket on the packed route
    ran the packed store once a shard, the others never."""
    from wvpk_torch.engine import pipeline
    from wvpk_torch.ops import decorr_cuda
    from wvpk_torch.parallel.mesh import launch_sharded_bucket, make_mesh

    _c, _d, states_of = _packed_corpus()
    stores = []

    def spy(*a, pack=None, **kw):
        stores.append(pack is not None)
        return launch(*a, pack=pack, **kw)

    launch = decorr_cuda._launch
    mp = pytest.MonkeyPatch()
    mp.setattr(decorr_cuda, "_launch", spy)
    try:
        for b in group_blocks(states_of(name)):
            want = _cpu_delivery(b)
            packed = pipeline.packed_route(b) is not None
            for n in (1, 2, 3):
                mesh = make_mesh(devices=[cuda] * n)
                stores.clear()
                shards = launch_sharded_bucket(b, mesh)
                payload = torch.cat([lb.payload for lb in shards],
                                    dim=1 if shards[0].bps is None else 0)
                crcmute = torch.cat([lb.crcmute for lb in shards], dim=1)
                assert torch.equal(want[0], payload.cpu()), (name, mesh)
                assert torch.equal(want[1], crcmute.cpu()), (name, mesh)
                assert stores == [packed] * len(shards), (name, stores)
    finally:
        mp.undo()


@pytest.mark.parametrize("ch", [0, 3])
def test_packed_store_decode_states_on_the_card(cuda, ch):
    """decode_states of every corpus together on the card, in one fetch
    and in chunks of 3 blocks, equal to the CPU's blocks; the decorrelation
    wrapper counts a launch for each packed bucket, and its chain
    kernels' launches."""
    from wvpk_torch.config import set_options

    corpus, names, states_of = _packed_corpus()
    states = [st for n in sorted(corpus) for st in states_of(n)]
    want = decode_states(states, device="cpu")
    set_options(delivery_chunk_blocks=ch)
    try:
        before = decorr_post_cuda.launches
        got = decode_states(states, device=cuda)
    finally:
        set_options(delivery_chunk_blocks=0)
    assert decorr_post_cuda.launches > before
    for w, g in zip(want, got):
        _same(w, g)


def wvx_inputs(seed, T, L, C):
    """Random wvx injection inputs: values up to 24 bits, 0-8 sent bits,
    old-style and max_width streams, every re-expansion arm, short lanes
    and FALSE_STEREO lanes (mono layout). Returns numpy arrays in
    wvx_inject's argument order."""
    rng = np.random.default_rng(seed)
    out = rng.integers(-2**23, 2**23, (T, L, C)).astype(np.int32)
    ns = rng.integers(T // 2, T + 1, L).astype(np.int32)
    out[np.arange(T)[:, None] >= ns[None, :]] = 0
    words = rng.integers(0, 2**32, (L, 4 * T * C // 32 + 16),
                         dtype=np.uint64).astype(np.uint32).view(np.int32)
    start_bit = rng.choice([0, 5], L).astype(np.int32)
    start_bc = np.where(start_bit == 5, 3, 0).astype(np.int32)
    sent = rng.integers(0, 9, L).astype(np.int32)
    mw = rng.choice([0, 0, 30, 26], L).astype(np.int32)
    zod = np.zeros((L, 3), np.int32)
    arm = rng.integers(0, 4, L)
    for i in range(L):
        if arm[i] < 3:
            zod[i, arm[i]] = rng.integers(1, 4)
    fs = (rng.random(L) < 0.4) if C == 1 else np.zeros(L, bool)
    return out, ns, words, start_bit, start_bc, sent, mw, zod, fs


@pytest.mark.parametrize("C", [1, 2], ids=["mono_false_stereo", "stereo"])
def test_wvx_kernel_matches_plain(cuda, C):
    arrays = [torch.from_numpy(a).to(cuda) for a in wvx_inputs(3, 80, 40, C)]
    got = wvx_inject_cuda(*arrays)
    want = wvx_inject(*arrays)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("mono", [False, True],
                         ids=["stereo", "mono_false_stereo"])
def test_wvx_kernel_edge_lanes(cuda, mono):
    """The wvx edge lanes (testgen/edge.py::wvx_edge_lanes: every
    sent_bits class, truncations that read fewer bits or none, start_bc of
    both signs, cursors run past the row's end, every re-expansion arm,
    FALSE_STEREO lanes, lanes outside the 32-bit cursor range) at 320
    samples, several of the kernel's chunks, exact against the plain scan;
    the int64 body runs exactly the lanes int64_lanes names."""
    *arrays, fs = wvx_edge_lanes(64, seed=3, mono=mono, steps=320)
    args = _on(cuda, *arrays)
    fs = torch.from_numpy(fs).to(cuda) if fs.any() else None
    got = wvx_inject_cuda(*args, fs)
    want = wvx_inject(*args, fs)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    T, _L, C = args[0].shape
    wide = int(wvx_int64_lanes(T, C, args[1], args[3], args[5], fs).sum())
    assert int(wvx_inject_cuda.wide_lanes) == wide > 0


FAMILIES = ("any", "hybrid", "wvx", "float", "wvc", "int32")


def pcm_case(seed):
    """A random PCM file (specs from wvpk.testgen.fuzzspec: mono, false
    stereo, joint, 1-16 terms incl. cross terms, 8-32 bit, shift, block
    checksums), sometimes with a corrupted byte. Seeds take the families
    in turn: any (random_spec's own mix), hybrid, int32+wvx, float, a
    hybrid file paired with its .wvc (random_wvc_spec) and int32
    zeros/ones/dups. Returns (.wv bytes, .wvc bytes or None, pcm,
    spec)."""
    from wvpk.testgen.fuzzspec import random_pcm, random_spec, \
        random_wvc_spec

    rng = np.random.default_rng(3000 + seed)
    family = FAMILIES[seed % len(FAMILIES)]
    wvc = family == "wvc"
    while True:
        if wvc:
            spec = random_wvc_spec(rng)
        elif family in ("any", "float"):
            spec = random_spec(rng, family=None if family == "any"
                               else family)
        else:
            spec = random_spec(rng, family="plain" if family == "hybrid"
                               else "int32")
        if family != "hybrid" or spec.hybrid:
            if family not in ("wvx", "int32") \
                    or (spec.int32_mode == "wvx") == (family == "wvx"):
                break
    n = int(rng.integers(spec.block_samples // 2,
                         spec.block_samples * 2 + 1))
    pcm = random_pcm(rng, n, spec.nch_data, spec)
    sink = [] if wvc else None
    data = b"".join(encode_blocks(pcm, spec, wvc_sink=sink))
    if rng.random() < 0.25:
        data = bytearray(data)
        data[int(rng.integers(64, len(data)))] ^= int(rng.integers(1, 256))
        data = bytes(data)
    return data, b"".join(sink) if wvc else None, pcm, spec


def parse_case(data, wvc, parse=parse_blocks, pair=pair_wvc):
    """Blocks of a case's bytes, its .wvc paired, parsed by `parse` (the
    port's container by default, wvpk's where a test passes it)."""
    blocks = parse(data)
    if wvc is not None:
        pair(blocks, wvc)
    return blocks


def dsd_case(seed):
    """A random DSD file: mode 0, 1 or 3, mono or stereo, random block
    size, for mode 1 history bits 0-5; random bytes or run-heavy ones
    (large probability skew), sometimes with a corrupted byte. Returns
    (bytes, source bytes (n, ch), mode)."""
    rng = np.random.default_rng(5000 + seed)
    mode = (0, 1, 3)[seed % 3]
    mono = bool(rng.random() < 0.4)
    ch = 1 if mono else 2
    n = int(rng.integers(100, 700))
    src = rng.integers(0, 256, (n, ch))
    if rng.random() < 0.5:
        runs = rng.choice([0x55, 0xAA, 0x33, 0x0F], (n, ch))
        src = np.where(rng.random((n, ch)) < 0.7, runs, src)
    kw = {"history_bits": int(rng.integers(0, 6))} if mode == 1 else {}
    data = encode_dsd_file(src.astype(np.int64), mode, mono=mono,
                           block_samples=int(rng.integers(64, 400)), **kw)
    if rng.random() < 0.3:
        data = bytearray(data)
        data[int(rng.integers(64, len(data)))] ^= int(rng.integers(1, 256))
        data = bytes(data)
    return data, src, mode


def lossless_case(seed):
    """A random lossless integer file (the families of pcm_case without
    hybrid, float and wvx), sometimes with a corrupted byte. Returns
    (data, pcm, spec)."""
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


def _same(w, g, msg=""):
    np.testing.assert_array_equal(w.samples, g.samples, err_msg=msg)
    assert (w.crc, w.crc_x, w.crc_wvc, w.mute_error, w.crc_error,
            w.wvc_applied) == (g.crc, g.crc_x, g.crc_wvc, g.mute_error,
                               g.crc_error, g.wvc_applied), msg


def test_decode_states_cuda_matches_cpu_and_oracle(cuda):
    files = [parse_blocks(STREAMS[n]()) for n in sorted(STREAMS)]
    files += [WVC_PAIRS[n]() for n in sorted(WVC_PAIRS)]
    files.append(parse_blocks(encode_multichannel(
        noise(600, 6, 3000, 6), EncodeSpec(block_samples=300, joint=True))))
    files.append(parse_blocks(encode_file(
        np.random.default_rng(13).integers(-2**22, 2**22, size=(300, 2)),
        EncodeSpec(block_samples=150, float_data=True, bytes_stored=4,
                   float_shift=0, float_max_exp=130, float_norm_exp=127))))
    files.append(parse_blocks(encode_file(
        np.random.default_rng(14).integers(-2**29, 2**29, size=(300, 1)),
        EncodeSpec(block_samples=150, bytes_stored=4, false_stereo=True,
                   int32_mode="wvx", int32_sent_bits=6,
                   int32_max_width=30))))
    states = [b.state for f in files for b in f]
    got = decode_states(states, device=cuda)
    want = decode_states(states, device="cpu")
    for st, w, g in zip(states, want, got):
        _same(w, g)
        if not g.crc_error:
            np.testing.assert_array_equal(decode_block(st).samples,
                                          g.samples)


@pytest.mark.parametrize("seed", range(24))
def test_fuzz_every_pcm_family_cuda_matches_cpu(cuda, seed):
    """Random files of every PCM family, .wvc pairs included: the
    kernels' decode equals the plain versions', flags included."""
    data, wvc, _pcm, spec = pcm_case(seed)
    states = [b.state for b in parse_case(data, wvc)]
    got = decode_states(states, device=cuda)
    want = decode_states(states, device="cpu")
    for w, g in zip(want, got):
        _same(w, g, f"seed {seed} {spec}")


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_dsd_cuda_matches_cpu(cuda, seed):
    """Random DSD files of every mode, corrupted ones included: the
    kernels' decode equals the plain versions', flags included, and the
    source bytes wherever a block decodes cleanly."""
    data, src, mode = dsd_case(seed)
    blocks = parse_blocks(data)
    states = [b.state for b in blocks]
    got = decode_states(states, device=cuda)
    want = decode_states(states, device="cpu")
    for blk, w, g in zip(blocks, want, got):
        _same(w, g, f"seed {seed} mode {mode}")
        if blk.header.block_samples and not g.crc_error:
            lo = blk.header.block_index
            np.testing.assert_array_equal(
                g.samples, src[lo:lo + blk.header.block_samples])


def dsd_group(mode, mono, seed, lanes=3, nsamp=500, smooth=False,
              **kw):
    """Block states of `lanes` one-block DSD files of one profile, each
    37 samples shorter than the one before (one group pads to its longest
    lane; the shorter rows end inside a 4-byte word)."""
    rng = np.random.default_rng(seed)
    ch = 1 if mono else 2
    states = []
    for k in range(lanes):
        d = rng.integers(0, 256, (nsamp - 37 * k, ch))
        if smooth:
            d = (d % 4) * 0x55
        states += [b.state for b in parse_blocks(encode_dsd_file(
            d.astype(np.int64), mode, mono=mono, **kw))
            if b.state.header.block_samples]
    return states


def dsd_kernel_args(states, device):
    """The staged inputs of a DSD kernel for one profile group, as
    engine/dsd_pipeline.py stages them: (args, keywords)."""
    (g,) = group_dsd(states)
    t = group_tensors(g, device)
    prof = g.prof
    if prof.mode == 1:
        return ((t["data"], t["nbytes"], t["summed"], t["value0"],
                 t["nvals"]),
                dict(bins=prof.bins, mono=prof.mono, nsteps=g.nsteps))
    return ((t["data"], t["nbytes"], t["ptable"], t["filters"], t["value0"],
             t["nsamples"]), dict(mono=prof.mono, nsteps=g.nsteps))


DSD_KERNELS = {
    "fast_mono_bins1": (1, True, dict(history_bits=0)),
    "fast_stereo_bins2": (1, False, dict(history_bits=1)),
    "fast_stereo_bins8_smooth": (1, False, dict(history_bits=3)),
    "fast_stereo_bins32": (1, False, dict(history_bits=5)),
    "high_stereo": (3, False, {}),
    "high_mono": (3, True, {}),
}


@pytest.mark.parametrize("name", sorted(DSD_KERNELS))
def test_dsd_kernels_match_plain(cuda, name):
    """Each DSD kernel instantiation against its plain version on small
    streams; a clean stream's CRCs equal the block headers'."""
    mode, mono, kw = DSD_KERNELS[name]
    states = dsd_group(mode, mono, 100 + len(name), smooth="smooth" in name,
                       **kw)
    args, kwargs = dsd_kernel_args(states, cuda)
    kernel, plain = ((dsd_fast_decode_cuda, dsd_fast_decode_bytes)
                     if mode == 1 else
                     (dsd_high_decode_cuda, dsd_high_decode_bytes))
    got = kernel(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    hdr = torch.tensor([st.header.crc for st in states], dtype=torch.int32)
    assert torch.equal(got[-1].cpu(), hdr)


@pytest.mark.parametrize("profile", sorted(DSD_EDGE_PROFILES))
def test_dsd_kernel_edge_lanes_match_plain(cuda, profile):
    """64 edge lanes per DSD profile (testgen/edge.py: empty rows, the
    mult == 0 reset with 4 and fewer bytes left, indexes past the table,
    truncated payloads, rows at the 65,280 ceiling; mode 3 filters outside
    the 32-bit body's range, all-0x00 and all-0xff payloads; byte counts
    ending 1 to 3 bytes before the row width): out, err and crc equal the
    plain version's; the mode-3 kernel ran exactly the out-of-range lanes
    in its int64 body."""
    states = dsd_edge_states(profile, 64, seed=9)
    args, kwargs = dsd_kernel_args(states, cuda)
    mode = DSD_EDGE_PROFILES[profile][0]
    kernel, plain = ((dsd_fast_decode_cuda, dsd_fast_decode_bytes)
                     if mode == 1 else
                     (dsd_high_decode_cuda, dsd_high_decode_bytes))
    got = kernel(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    if mode == 3:
        wide = int(int64_lanes(args[2], args[3], kwargs["mono"]).sum())
        assert int(dsd_high_decode_cuda.wide_lanes) == wide > 0


def test_dsd_wrappers_refuse_what_the_kernels_cannot_decode(cuda):
    """A summed entry outside [0, 65535] (the kernel holds the tables as
    uint16), a byte count past the row width and a row width that is not
    whole words: ValueError, no launch."""
    states = dsd_group(1, False, 120, history_bits=2)
    args, kwargs = dsd_kernel_args(states, cuda)
    n = dsd_fast_decode_cuda.launches
    for k, v in ((2, 1 << 16), (2, -1), (1, args[0].shape[1] + 1)):
        bad = list(args)
        bad[k] = bad[k].clone()
        bad[k][-1] = v
        with pytest.raises(ValueError):
            dsd_fast_decode_cuda(*bad, **kwargs)
    with pytest.raises(ValueError, match="multiple of 4"):
        dsd_fast_decode_cuda(args[0][:, :-1].contiguous(), *args[1:],
                             **kwargs)
    assert dsd_fast_decode_cuda.launches == n


def test_dsd_groups_on_side_streams_match_sequence(cuda):
    """A call's mode-1 and mode-3 groups launch on side streams
    (dsd_pipeline.decode_groups): the same outputs as the groups decoded
    one after another on the current stream, one launch a group."""
    from wvpk_torch.engine import dsd_pipeline as dp

    states = [st for p in ("fast_bins4", "fast_bins32", "high", "high_mono")
              for st in dsd_edge_states(p, 64, seed=10)]
    states += dsd_group(0, False, 121)
    groups = dp.group_dsd(states)
    staged = [dp.group_tensors(g, cuda) for g in groups]
    fast, high = (dsd_fast_decode_cuda.launches,
                  dsd_high_decode_cuda.launches)
    side = dp.decode_groups(groups, staged)
    assert (dsd_fast_decode_cuda.launches - fast,
            dsd_high_decode_cuda.launches - high) == (2, 2)
    seq = [dp.decode_group(g, t) for g, t in zip(groups, staged)]
    torch.cuda.synchronize()
    for s, q in zip(side, seq):
        for a, b in zip(s, q):
            assert (a is None and b is None) or torch.equal(a, b)


def _chains(rng, L, mono, pool=None, most=17):
    """Random term chains, one a lane, 0 to most - 1 passes: (terms,
    deltas, num_terms) as numpy arrays."""
    pool = pool or (MONO_TERMS if mono else ALL_TERMS)
    terms = np.zeros((L, 16), np.int32)
    deltas = np.zeros((L, 16), np.int32)
    nt = rng.integers(0, most, L).astype(np.int32)
    for i in range(L):
        terms[i, :nt[i]] = rng.choice(pool, nt[i])
        deltas[i, :nt[i]] = rng.integers(0, 8, nt[i])
    return terms, deltas, nt


def _seeds(rng, L):
    return (rng.integers(-900, 900, (L, 16)), rng.integers(-900, 900, (L, 16)),
            rng.integers(-2**14, 2**14, (L, 16, 8)),
            rng.integers(-2**14, 2**14, (L, 16, 8)))


def _on(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


# the chains of the invert kernel test: "random" (a chain a lane, every
# term class, cross terms in mono chains too: the run-time kernel), each
# compiled chain of ENCODE_CHAINS given as static_terms, a chain outside
# them and a mono chain with cross terms (static_terms names them: the run-time
# kernel)
INVERT_CHAINS = ([("random", False), ("random", True)]
                 + [(name, m) for name, m, _t in ENCODE_CHAINS]
                 + [("outside", False), ("outside", True),
                    ("cross_mono", True)])
_INVERT_OUTSIDE = {"outside": {False: (5, 1, -3, 17), True: (5, 1, 17)},
                   "cross_mono": {True: (18, -1, 17, -2, 3)}}


@pytest.mark.parametrize("chain,mono", INVERT_CHAINS,
                         ids=[f"{c}{'_m' if m else ''}"
                              for c, m in INVERT_CHAINS])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["main", "warm_state"])
def test_encode_invert_kernel_matches_plain(cuda, chain, mono, with_state):
    """Residuals and final state of the invert kernel against the plain
    scan: random chains of 0-16 passes ("random"), or every lane on one
    chain given as static_terms (its compiled kernel for each of
    ENCODE_CHAINS, the run-time kernel for the others); random seeds and
    deltas, values up to 2^20, 300 lanes of 97 steps (not a multiple of
    the ring's 8 or the staging tile's 32). The launch counts the kernel
    that ran."""
    from wvpk_torch.ops.encode_cuda import decorr_invert_cuda, \
        invert_instance
    from wvpk_torch.ops.encode_kernels import decorr_invert_warm

    named = {n: t for n, _m, t in ENCODE_CHAINS}
    rng = np.random.default_rng(40 + 2 * len(chain) + mono + 4 * with_state)
    T, L, C = 97, 300, 1 if mono else 2
    targ = rng.integers(-2**20, 2**20, (T, L, C)).astype(np.int32)
    terms, deltas, nt = _chains(rng, L, mono, pool=ALL_TERMS)
    static = None
    if chain != "random":
        static = named.get(chain) or _INVERT_OUTSIDE[chain][mono]
        terms[:] = 0
        terms[:, :len(static)] = static
        deltas[:] = 0
        deltas[:, :len(static)] = rng.integers(0, 8, (L, len(static)))
        nt[:] = len(static)
    args = _on(cuda, targ, terms, deltas, nt, *_seeds(rng, L))
    kw = dict(mono=mono, with_state=with_state)
    ran = invert_instance(chain if chain in named else "generic_mono"
                          if mono else "generic", with_state)
    before = dict(decorr_invert_cuda.chain_launches)
    got = decorr_invert_cuda(*args, static_terms=static, **kw)
    want = decorr_invert_warm(*args, **kw)
    torch.cuda.synchronize()
    if not with_state:
        got, want = (got, ()), (want, ())
    assert torch.equal(want[0], got[0])
    for w, g in zip(want[1], got[1]):
        assert torch.equal(w, g)
    assert {k: v - before[k] for k, v in
            decorr_invert_cuda.chain_launches.items() if v != before[k]} \
        == {ran: 1}


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["main", "warm_state"])
@pytest.mark.parametrize("kind", ["hybrid", "hybrid_mono"])
def test_encode_invert_kernel_edge_lanes_match_plain(cuda, kind,
                                                     with_state):
    """The hybrid encode edge lanes' targets, chains and seeds
    (testgen/edge.py::encode_edge_lanes: residuals at INT32_MIN/MAX,
    silence, every lane on ENCODE_EDGE_CHAIN, one in four with random
    seeds) through the invert: the chain's kernel (static_terms) and the
    run-time kernel, exact against the plain scan."""
    from wvpk_torch.ops.encode_cuda import decorr_invert_cuda, \
        invert_instance
    from wvpk_torch.ops.encode_kernels import decorr_invert_warm

    mono = kind.endswith("_mono")
    a = _on(cuda, *encode_edge_lanes(kind, 64, seed=7))
    args = a[:4] + a[9:]
    kw = dict(mono=mono, with_state=with_state)
    want = decorr_invert_warm(*args, **kw)
    want = (want, ()) if not with_state else want
    m = "_mono" if mono else ""
    for static, ran in ((ENCODE_EDGE_CHAIN, "default" + m),
                        (None, "generic" + m)):
        before = dict(decorr_invert_cuda.chain_launches)
        got = decorr_invert_cuda(*args, static_terms=static, **kw)
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in
                decorr_invert_cuda.chain_launches.items()
                if v != before[k]} == {invert_instance(ran, with_state): 1}
        got = (got, ()) if not with_state else got
        assert torch.equal(want[0], got[0])
        for w, g in zip(want[1], got[1]):
            assert torch.equal(w, g)


def _residual_words(rng, kind, W, L):
    if kind == "normal":
        r = rng.normal(0, 600, (W, L))
    elif kind == "runs":
        r = rng.normal(0, 3, (W, L)).round()
        r[rng.random((W, L)) < 0.7] = 0
        r[: W // 4] = 0
    elif kind == "escapes":
        r = rng.normal(0, 50, (W, L))
        big = rng.random((W, L)) < 0.05
        r = np.where(big, rng.integers(1 << 20, 1 << 26, (W, L)), r)
    else:
        r = rng.integers(-(1 << 30), 1 << 30, (W, L))
    return np.asarray(r, np.int64).astype(np.int32)


# the int32 body's limits: 2^31 - 1 (the largest staged median it takes;
# an increase wraps it) and values past int32, which the int64 body codes
MEDIAN_LIMITS = ((1 << 31) - 1, 1 << 31, 1 << 33, 1 << 40)


@pytest.mark.parametrize("medians", ["usual", "limits"])
@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
@pytest.mark.parametrize("kind", ["normal", "runs", "escapes", "huge"])
def test_encode_words_kernel_matches_plain(cuda, kind, mono, medians):
    """The payload and bit totals of the words kernel against the plain
    scan packed with its final flush: zero runs, LIMIT_ONES escapes,
    medians from 0 to 2^18 ("usual") and, in one lane in two, a median at
    the 32-bit body's limit or past it ("limits"; those lanes take the
    int64 body, as int64_lanes counts), short and empty lanes; 240
    lanes."""
    from wvpk_torch.ops.encode_cuda import encode_words_cuda, \
        encode_words_plain, int64_lanes

    rng = np.random.default_rng(50 + 2 * len(kind) + mono)
    W, L = 200, 240
    res = _residual_words(rng, kind, W, L)
    med0 = np.zeros((L, 2, 3), np.int64)
    for i in range(L):
        base = [0, 1, 3, 9, 1 << 18][i % 5]
        for c in range(1 if mono else 2):
            med0[i, c] = sorted(rng.integers(base, base * 4 + 4, 3))
    if medians == "limits":
        for i in range(0, L, 2):
            c = 0 if mono else (i // 2) % 2
            med0[i, c, (i // 4) % 3] = MEDIAN_LIMITS[(i // 2) % 4]
    nvals = rng.integers(0, W + 1, L).astype(np.int32)
    nvals[:4] = (W, W - 1, 3, 0)
    args = _on(cuda, res, med0, nvals)
    got = encode_words_cuda(*args, mono=mono)
    want = encode_words_plain(*args, mono=mono)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    wide = int(int64_lanes(args[1]).sum())
    assert int(encode_words_cuda.wide_lanes) == wide
    assert (wide > 0) == (medians == "limits")


def test_encode_words_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    """The words kernel takes int32 words (W, L), int64 medians (L, 2, 3)
    and word counts (L,), all on the card: anything else is refused before
    a launch. Medians past int32 are taken (the int64 body)."""
    from wvpk_torch.ops.encode_cuda import encode_words_cuda

    rng = np.random.default_rng(59)
    res, med0, nvals = _on(cuda, _residual_words(rng, "normal", 16, 8),
                           np.zeros((8, 2, 3), np.int64),
                           np.full(8, 16, np.int32))
    before = encode_words_cuda.launches
    for bad in ((res.to(torch.int64), med0, nvals),
                (res, med0.to(torch.int32), nvals),
                (res, med0[:, :1].contiguous(), nvals),
                (res, med0, nvals[:4]),
                (res.t(), med0, nvals),
                (res.cpu(), med0, nvals)):
        with pytest.raises(ValueError):
            encode_words_cuda(*bad, mono=False)
    assert encode_words_cuda.launches == before
    encode_words_cuda(res, med0 + (1 << 40), nvals, mono=False)
    assert int(encode_words_cuda.wide_lanes) == 8


HYBRID_PROFILES = {"plain": (False, False), "bitrate": (True, False),
                   "bitrate_balance": (True, True)}


# the chains of the hybrid kernel test: "random" (a chain a lane, the
# run-time kernel), each compiled chain with static_terms, and one chain
# outside ENCODE_CHAINS named by static_terms (the run-time kernel)
HYBRID_CHAINS = (["random"] + [name for name, _m, _t in ENCODE_CHAINS]
                 + ["outside"])
_OUTSIDE = {False: (5, 1, -3, 17), True: (5, 1, 17)}


@pytest.mark.parametrize("chain", HYBRID_CHAINS)
@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
@pytest.mark.parametrize("profile", sorted(HYBRID_PROFILES))
def test_encode_hybrid_kernel_matches_plain(cuda, profile, mono, chain):
    """Payload, bit totals and reconstruction of the fused hybrid kernel
    against the plain scan packed: random chains and seeds ("random"), or
    every lane on one chain given as static_terms (each of ENCODE_CHAINS
    of the test's channel count: its compiled kernel; "outside": the run-time
    kernel), silent stretches (the run gate), error limits from 0 up;
    200 lanes. The launch counts the kernel that ran."""
    from wvpk_torch.ops.encode_cuda import hybrid_encode_cuda, \
        hybrid_encode_plain

    named = {n: (m, t) for n, m, t in ENCODE_CHAINS}
    if chain in named and named[chain][0] != mono:
        pytest.skip(f"{chain} is a chain of the other channel count")
    bitrate, balance = HYBRID_PROFILES[profile]
    rng = np.random.default_rng(60 + 2 * len(profile) + mono)
    T, L, C = 90, 200, 1 if mono else 2
    targ = rng.integers(-2**15, 2**15, (T, L, C)).astype(np.int32)
    targ[:20, ::3] = 0
    terms, deltas, nt = _chains(rng, L, mono, most=8)
    static = None
    if chain != "random":
        static = named[chain][1] if chain in named else _OUTSIDE[mono]
        terms[:] = 0
        terms[:, :len(static)] = static
        deltas[:, len(static):] = 0
        deltas[:, :len(static)] = rng.integers(0, 8, (L, len(static)))
        nt[:] = len(static)
    med0 = np.zeros((L, 2, 3), np.int64)
    for i in range(L):
        for c in range(2):
            med0[i, c] = sorted(rng.integers(0 if i % 7 == 0 else 1, 600, 3))
    slow0 = rng.integers(0, 3000, (L, 2)).astype(np.int64)
    acc0 = (rng.integers(0, 40, (L, 2)) << 16).astype(np.int64)
    delta0 = rng.integers(0, 3, (L, 2)).astype(np.int64)
    nvals = rng.integers(0, T * C + 1, L).astype(np.int32)
    nvals[:2] = (T * C, T * C - 1)
    args = _on(cuda, targ, terms, deltas, nt, med0, slow0, acc0, delta0,
               nvals, *_seeds(rng, L))
    kw = dict(mono=mono, hybrid_bitrate=bitrate, hybrid_balance=balance)
    ran = chain if chain in named else "generic_mono" if mono else "generic"
    before = dict(hybrid_encode_cuda.chain_launches)
    got = hybrid_encode_cuda(*args, static_terms=static, **kw)
    want = hybrid_encode_plain(*args, **kw)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert {k: v - before[k] for k, v in
            hybrid_encode_cuda.chain_launches.items() if v != before[k]} \
        == {ran: 1}


@pytest.mark.parametrize("profile", sorted(HYBRID_PROFILES))
@pytest.mark.parametrize("kind", ENCODE_EDGE_KINDS)
def test_encode_kernels_edge_lanes_match_plain(cuda, kind, profile):
    """The 64 encode edge lanes of each kind (testgen/edge.py::
    encode_edge_lanes: residuals at INT32_MIN/MAX, zero runs across the
    staging tiles and to the lane's end, escapes with gammas past 32
    bits, medians at and past the 32-bit body's limits, error limits of
    0, negative and above any interval, 32-step searches, both balance
    clamps) through each word coder, exact against its plain version; the
    hybrid lanes through their chain's kernel (static_terms) and the
    run-time kernel; the lanes of the int64 body counted."""
    from wvpk_torch.ops.encode_cuda import encode_words_cuda, \
        encode_words_plain, hybrid_encode_cuda, hybrid_encode_plain, \
        int64_lanes

    mono = kind.endswith("_mono")
    args = _on(cuda, *encode_edge_lanes(kind, 64, seed=7))
    if kind.startswith("words"):
        if profile != "plain":
            pytest.skip("the word coder has no hybrid profile")
        runs = [(encode_words_cuda, encode_words_plain(*args, mono=mono),
                 dict(mono=mono), args[1])]
    else:
        bitrate, balance = HYBRID_PROFILES[profile]
        kw = dict(mono=mono, hybrid_bitrate=bitrate, hybrid_balance=balance)
        want = hybrid_encode_plain(*args, **kw)
        runs = [(hybrid_encode_cuda, want, dict(kw, static_terms=st), args[4])
                for st in (ENCODE_EDGE_CHAIN, None)]
    for fn, want, kw, med0 in runs:
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        for w, g in zip(want, got):
            assert torch.equal(w, g)
        wide = int(int64_lanes(med0).sum())
        assert wide > 0 and int(fn.wide_lanes) == wide


def _wide_pcm(n, seed):
    """32-bit stereo whose low bits vary: the encoder routes it to wvx."""
    return (noise(n, 2, 5000, seed) * (1 << 14)) | 1


ENCODE_FILES = {
    "lossless_default": lambda: (noise(1500, 2, 3000, 70),
                                 dict(block_samples=512)),
    "lossless_high_mono": lambda: (noise(1500, 1, 3000, 71),
                                   dict(block_samples=512, preset="high")),
    "hybrid": lambda: (noise(1500, 2, 4000, 72),
                       dict(block_samples=512, hybrid=True, bitrate=420)),
    "hybrid_fast_mono": lambda: (noise(1500, 1, 4000, 73),
                                 dict(block_samples=512, hybrid=True,
                                      bitrate=380, preset="fast")),
    "wvx": lambda: (_wide_pcm(1100, 74), dict(block_samples=512,
                                              bytes_per_sample=4)),
    "float": lambda: ((noise(1100, 2, 3000, 75) / 65536.0).astype(
        np.float32), dict(block_samples=512)),
    "multichannel_24bit": lambda: (noise(1100, 6, 2**20, 76),
                                   dict(block_samples=512,
                                        bytes_per_sample=3)),
}


@pytest.mark.parametrize("name", sorted(ENCODE_FILES))
def test_encode_device_cuda_matches_cpu(cuda, name):
    """encode_device on the card writes the same bytes as on the CPU (the
    plain versions, held equal to wvpk's device encoder by the tier-1
    tests), and the file decodes cleanly on the card; the lossless ones
    sample-exact."""
    from wvpk_torch.encode import encode_device

    pcm, kw = ENCODE_FILES[name]()
    got = encode_device(pcm, device=cuda, **kw)
    assert got == encode_device(pcm, device="cpu", **kw)
    res = decode_states([b.state for b in parse_blocks(got)], device=cuda)
    assert not any(r.crc_error or r.mute_error for r in res)
    if "hybrid" not in name and name != "float" and pcm.shape[1] <= 2:
        np.testing.assert_array_equal(
            np.concatenate([r.samples for r in res]), pcm)


def hybrid_float_wvc(parse=parse_blocks):
    """Hybrid float blocks, each given a correction stream: random .wvc
    bits and a wvc CRC of 0 (testgen refuses a .wvc with float content, so
    no corpus reaches this path). Float shift 3 and max_exp 133 make the
    float restore change the samples. The same bytes for any `parse`."""
    rng = np.random.default_rng(31)
    data = encode_file(rng.integers(-2**22, 2**22, size=(600, 2)), EncodeSpec(
        block_samples=150, float_data=True, bytes_stored=4, float_shift=3,
        float_max_exp=133, float_norm_exp=127, hybrid=True, bitrate=512))
    return [dataclasses.replace(
        b.state, wvc_crc=0, wvcbits=rng.integers(
            0, 256, int(rng.integers(64, 400)), dtype=np.uint8).tobytes())
        for b in parse(data)]


def test_hybrid_float_wvc_cuda_matches_cpu_and_oracle(cuda):
    states = hybrid_float_wvc()
    got = decode_states(states, device=cuda)
    for st, w, g in zip(states, decode_states(states, device="cpu"), got):
        _same(w, g)
        want = decode_block(st)
        np.testing.assert_array_equal(want.samples, g.samples)
        assert g.wvc_applied and g.crc_wvc == want.crc_wvc


def _mixed_chain_states():
    """A bucket of 145 lanes on four chains: three of CHAINS, 70, 66 and
    64 lanes (a segment each), and 5 lanes on a chain outside it."""
    mix = (((18, 17, 2), 70), ((17, 17), 66), ((18, 18, 2, 17, 3), 64),
           ((18, 2), 5))
    data = b"".join(encode_file(noise(64 * n, 2, 3000, 80 + k), EncodeSpec(
        block_samples=64, joint=True, terms=terms, deltas=(2,) * len(terms)))
        for k, (terms, n) in enumerate(mix))
    return [b.state for b in parse_blocks(data)]


def test_sharded_decode_states_on_a_repeated_device(cuda):
    """sharded_decode_states over two and three entries of the one card:
    the mixed-chain bucket (its chain runs split across shards), a DSD
    call and a mesh larger than a bucket decode as unsharded, and every
    table chain's kernel launches on the shards."""
    from wvpk_torch.parallel import sharded_decode_states

    mixed = _mixed_chain_states()
    dsd = [b.state for b in parse_blocks(encode_dsd_file(
        np.random.default_rng(81).integers(0, 256, (64 * 7, 2)), 3,
        block_samples=64))]
    small = [b.state for b in parse_blocks(encode_file(
        noise(128, 2, 3000, 82), EncodeSpec(block_samples=64)))]
    for n in (2, 3):
        mesh = [f"cuda:{cuda.index or 0}"] * n
        for states in (mixed, dsd, small):
            want = decode_states(states, device=cuda)
            decorr_post_cuda.chain_launches.update(
                dict.fromkeys(decorr_post_cuda.chain_launches, 0))
            for w, g in zip(want, sharded_decode_states(states, mesh)):
                _same(w, g)
            if states is mixed:
                ran = decorr_post_cuda.chain_launches
                for name in ("bench", "fast", "default"):
                    assert ran[name] >= 1, ran
                assert ran["generic"] >= 1, ran


def test_sharded_encode_on_a_repeated_device(cuda):
    from wvpk_torch.encode import encode_device

    pcm, kw = ENCODE_FILES["lossless_default"]()
    want = encode_device(pcm, device=cuda, **kw)
    for n in (2, 3):
        assert encode_device(pcm, mesh=[cuda] * n, **kw) == want
    pcm, kw = ENCODE_FILES["hybrid"]()
    assert encode_device(pcm, mesh=[cuda] * 2, **kw) \
        == encode_device(pcm, device=cuda, **kw)


@pytest.mark.parametrize("ch", [2, 3, 512])
def test_chunked_delivery_on_the_card(cuda, ch):
    """delivery_chunk_blocks on the card: the pinned, event-closed copies
    give the single fetch's blocks."""
    from wvpk_torch.config import set_options

    states = _mixed_chain_states() + [b.state for b in parse_blocks(
        encode_dsd_file(np.random.default_rng(83).integers(
            0, 256, (64 * 5, 2)), 1, block_samples=64))]
    want = decode_states(states, device=cuda)
    set_options(delivery_chunk_blocks=ch)
    try:
        got = decode_states(states, device=cuda)
    finally:
        set_options(delivery_chunk_blocks=0)
    for w, g in zip(want, got):
        _same(w, g)


@pytest.mark.parametrize("ch", [0, 2])
def test_fetch_spans_on_the_card(cuda, ch):
    """Traced on the card: a single fetch counts its copy's bytes in
    `transfer.copy`, chunked delivery where each copy is queued
    (`transfer.enqueue`); both wait for the device in `transfer.wait`
    and lie within `transfer`."""
    from wvpk_torch import trace
    from wvpk_torch.config import set_options
    from wvpk_torch.engine import pipeline

    states = _mixed_chain_states()
    fetched = []

    def finish(handle, _finish=pipeline._finish_fetch):
        out = _finish(handle)
        fetched.append(sum(a.nbytes for a in out))
        return out

    set_options(delivery_chunk_blocks=ch)
    mp = pytest.MonkeyPatch()
    mp.setattr(pipeline, "_finish_fetch", finish)
    try:
        chunks = len(pipeline._chunks(states))
        with trace.collect() as sink:
            decode_states(states, device=cuda)
    finally:
        mp.undo()
        set_options(delivery_chunk_blocks=0)
    where = "transfer.enqueue" if ch else "transfer.copy"
    other = "transfer.copy" if ch else "transfer.enqueue"
    assert len(fetched) == chunks and (chunks > 1) == bool(ch)
    assert sink[f"{where}#bytes"] == sum(fetched)
    assert f"{other}#bytes" not in sink
    assert sink["transfer.wait"] > 0
    assert sink["transfer"] >= sum(sink[k] for k in (
        "transfer.enqueue", "transfer.wait", "transfer.copy",
        "transfer.split"))


def test_hw_sweep_on_the_card(cuda):
    from wvpk_torch.testgen.fuzzspec import run_hw_sweep

    for mesh in (None, [cuda, cuda]):
        fails, blocks = run_hw_sweep(n_cases=8, n_dsd=4, n_mc=1, n_wvc=2,
                                     device=cuda, mesh=mesh, verbose=False)
        assert fails == 0 and blocks > 0
