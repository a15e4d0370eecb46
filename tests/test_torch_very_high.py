"""WavPack's very high mode (`wavpack -hh`: 16 decorrelation passes) in
wvpk_torch: a stereo stream with a stretch written mono decodes through
the port's engine to the source, to wvpk's decode of the same bytes and
to the benchmark's scalar reference; its buckets route to the compiled
very high chains (ops/decorr_cuda.py::CHAINS), which the encode kernels
do not compile. Integer codec: every comparison is exact."""

import numpy as np
import pytest

from wvbench.ref.files import block_spans, decode_alone
from wvpk.container import parse_blocks as jax_parse_blocks
from wvpk.engine import decode_states as jax_decode_states
from wvpk_torch import trace
from wvpk_torch.container import parse_blocks
from wvpk_torch.engine import decode_states
from wvpk_torch.engine.staging import group_blocks
from wvpk_torch.ops.decorr_cuda import CHAINS, CLUSTER, ENCODE_CHAINS, \
    GENERIC, lane_runs
from wvpk_torch.ops.encode_cuda import chain_kernel
from wvpk_torch.testgen import EncodeSpec, encode_file
from wvpk_torch.testgen.encoder import encode_blocks

CHAIN = {name: (k, terms) for k, (name, _m, terms) in enumerate(CHAINS)}
VERY_HIGH = CHAIN["very_high"][1]
VERY_HIGH_MONO = CHAIN["very_high_mono"][1]
BLOCK = 1024


def very_high_stream(seed=16):
    """A seeded stereo stream on the very high chain, deltas 2, joint
    stereo, 1,024-sample blocks: 5 blocks of two partly correlated
    channels, a stretch of 2 blocks with equal channels (quiet noise,
    then digital silence) written mono as `wavpack` writes it (FALSE_STEREO,
    the mono chain), then 2 stereo blocks. Returns (bytes, pcm (n, 2))."""
    rng = np.random.default_rng(seed)
    t = np.arange(9 * BLOCK)
    a = 6000 * np.sin(2 * np.pi * 330 * t / 44100) + rng.normal(0, 900,
                                                                t.size)
    pcm = np.stack([a, 0.7 * a + rng.normal(0, 400, t.size)], 1)
    quiet = rng.normal(0, 40, BLOCK)
    pcm[5 * BLOCK:6 * BLOCK] = quiet[:, None]
    pcm[6 * BLOCK:7 * BLOCK] = 0
    pcm = np.clip(np.round(pcm), -32768, 32767).astype(np.int64)
    stereo = EncodeSpec(block_samples=BLOCK, joint=True, terms=VERY_HIGH,
                        deltas=(2,) * len(VERY_HIGH))
    mono = EncodeSpec(block_samples=BLOCK, false_stereo=True,
                      terms=VERY_HIGH_MONO,
                      deltas=(2,) * len(VERY_HIGH_MONO))
    total = len(pcm)
    blocks = []
    for spec, lo, hi in ((stereo, 0, 5), (mono, 5, 7), (stereo, 7, 9)):
        spec.total_samples_override = total
        part = pcm[lo * BLOCK:hi * BLOCK]
        blocks += encode_blocks(part[:, :1] if spec.false_stereo else part,
                                spec, start_sample=lo * BLOCK,
                                first=lo == 0, last=hi * BLOCK >= total)
    return b"".join(blocks), pcm


@pytest.fixture(scope="module")
def stream():
    return very_high_stream()


def test_very_high_stream_decodes_to_source_wvpk_and_reference(stream):
    """The port's engine on the CPU decodes every block to the source, to
    wvpk's engine on the same bytes, and to the benchmark's scalar
    reference (wvbench/ref/oracle.py) decoding each block alone; no block
    reports a CRC or mute error."""
    data, pcm = stream
    got = decode_states([b.state for b in parse_blocks(data)], device="cpu")
    want = jax_decode_states([b.state for b in jax_parse_blocks(data)])
    spans = block_spans(data)
    assert len(got) == len(want) == len(spans) == 9
    for k, (g, w, (lo, hi, index, n)) in enumerate(zip(got, want, spans)):
        assert not (g.crc_error or g.mute_error), k
        np.testing.assert_array_equal(g.samples, pcm[index:index + n])
        np.testing.assert_array_equal(np.asarray(w.samples), g.samples)
        assert (w.crc_error, w.mute_error) == (g.crc_error, g.mute_error)
        ref, crc_error, mute_error = decode_alone(data[lo:hi])
        assert not (crc_error or mute_error), k
        np.testing.assert_array_equal(ref, g.samples)


def test_very_high_buckets_route_to_compiled_chains(stream):
    """Staging gives the stream a stereo bucket on the very high chain and
    a mono bucket (the FALSE_STEREO stretch) on its mono chain, each named
    by static_terms; lane_runs sends each to its compiled kernel, and the
    decode counts every lane on a chain kernel (`launch#chain_lanes`),
    none on the generic one."""
    data, _pcm = stream
    states = [b.state for b in parse_blocks(data)]
    buckets = group_blocks(states)
    seen = {}
    for b in buckets:
        L = len(b.states)
        assert tuple(b.static_terms) == (VERY_HIGH_MONO if b.profile.mono
                                         else VERY_HIGH)
        runs = lane_runs(L, b.profile.mono, b.static_terms,
                         b.chain_segments)
        seen[b.profile.mono] = L
        name = "very_high_mono" if b.profile.mono else "very_high"
        assert runs == [(CHAIN[name][0], 0, L)]
    assert seen == {False: 7, True: 2}
    with trace.collect() as sink:
        decode_states(states, device="cpu")
    assert sink["launch#lanes"] == 9
    assert sink["launch#chain_lanes"] == 9
    assert sink["launch#generic_lanes"] == 0
    assert sink["launch#cluster_lanes"] == 9


LANE_RUNS = {
    "stereo": (VERY_HIGH, False, "very_high"),
    "mono": (VERY_HIGH_MONO, True, "very_high_mono"),
    "stereo_one_term_off": (VERY_HIGH[:-1] + (3,), False, None),
    "mono_with_cross_terms": (VERY_HIGH, True, None),
    "mono_chain_on_stereo": (VERY_HIGH_MONO, False, None),
}


@pytest.mark.parametrize("name", sorted(LANE_RUNS))
def test_lane_runs_very_high(name):
    """lane_runs maps the very high chains to their compiled ids, by
    channel count, and a chain outside the table to the generic kernel;
    inside a mixed bucket's segments too. The encode kernels do not
    compile them (ENCODE_CHAINS): encode_cuda.chain_kernel gives the
    run-time kernel."""
    terms, mono, kernel = LANE_RUNS[name]
    want = GENERIC if kernel is None else CHAIN[kernel][0]
    assert lane_runs(12, mono, static_terms=terms) == [(want, 0, 12)]
    segs = ((terms, 0, 5, len(terms)), ((17, 17), 5, 9, 2),
            (None, 9, 12, 16))
    runs = lane_runs(12, mono, chain_segments=segs)
    assert runs[0] == (want, 0, 5) and runs[-1] == (GENERIC, 9, 12)
    assert chain_kernel(12, mono, terms) == (
        GENERIC, "generic_mono" if mono else "generic")


def test_encode_chains_are_the_shared_table():
    """ENCODE_CHAINS is CHAINS up to the very high chains: the chains both
    the decode and the encode kernels compile, with the same ids."""
    assert ENCODE_CHAINS == CHAINS[:len(ENCODE_CHAINS)]
    assert [n for n, _m, _t in CHAINS[len(ENCODE_CHAINS):]] == [
        "very_high", "very_high_mono"]
    assert len(VERY_HIGH) == 16 and VERY_HIGH_MONO == tuple(
        t for t in VERY_HIGH if t > 0)


CLUSTER_FILES = {"very_high": (VERY_HIGH, True), "default": (
    CHAIN["default"][1], False)}


@pytest.mark.parametrize("name", sorted(CLUSTER_FILES))
def test_cluster_lanes_count_the_very_high_chains(name):
    """A traced CPU decode of a stereo file counts `launch#cluster_lanes`,
    the lanes the route sends to the cluster kernel: every lane of a
    very high file, none of a file on the default chain; every block
    equal to the source."""
    terms, cluster = CLUSTER_FILES[name]
    rng = np.random.default_rng(18)
    pcm = np.clip(np.round(rng.normal(0, 2000, (5 * BLOCK + 300, 2))),
                  -32768, 32767).astype(np.int64)
    data = encode_file(pcm, EncodeSpec(block_samples=BLOCK, joint=True,
                                       terms=terms,
                                       deltas=(2,) * len(terms)))
    states = [b.state for b in parse_blocks(data)]
    with trace.collect() as sink:
        got = decode_states(states, device="cpu")
    np.testing.assert_array_equal(
        np.concatenate([b.samples for b in got]), pcm)
    assert sink["launch#lanes"] == len(states) == 6
    assert sink["launch#chain_lanes"] == 6
    assert sink["launch#cluster_lanes"] == (6 if cluster else 0)


@pytest.mark.parametrize("name", [name for name, _m, _t in CHAINS])
def test_lane_runs_route_each_chain_to_its_kernel(name):
    """lane_runs gives every chain of CHAINS its own id, alone and as a
    segment of a mixed bucket; the ids of the decode-only table
    (WVPK_DECODE_CHAIN_TABLE, the very high chains) and only those run
    on the cluster kernel."""
    k, terms = CHAIN[name]
    mono = CHAINS[k][1]
    assert lane_runs(40, mono, static_terms=terms) == [(k, 0, 40)]
    segs = ((None, 0, 3, 16), (terms, 3, 40, len(terms)))
    assert lane_runs(40, mono, chain_segments=segs) == [(GENERIC, 0, 3),
                                                        (k, 3, 40)]
    assert (k in CLUSTER) == (k >= len(ENCODE_CHAINS))
    assert GENERIC not in CLUSTER
