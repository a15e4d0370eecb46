"""The decorrelation kernel's packed store on the CPU: which buckets take
the packed route (pipeline.packed_route), the delivered payload and
CRC/mute table unchanged against the chain a bucket took before it
(decode_tensors, then fused.deliver's pack_samples), the `launch#lanes`
and `launch#packed_lanes` counters, and the ctypes binding of the kernel's
C signature. The kernel itself is held against its plain version on the
card (tests/test_torch_cuda.py, `-k packed`). Integer codec: every
comparison is exact."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from wvpk_torch import trace
from wvpk_torch.config import get_options, set_options
from wvpk_torch.container import parse_blocks
from wvpk_torch.container.blocks import pair_wvc
from wvpk_torch.engine import decode_states, pipeline
from wvpk_torch.engine.fused import deliver, fused_decode
from wvpk_torch.engine.staging import bucket_tensors, group_blocks
from wvpk_torch.ops import decorr_cuda
from wvpk_torch.parallel import sharded_decode_states
from wvpk_torch.testgen import EncodeSpec, encode_file
from wvpk_torch.testgen.encoder import encode_blocks


def noise(n, ch, scale, seed):
    return np.round(np.random.default_rng(seed).normal(0, scale, (n, ch))
                    ).astype(np.int64)


def _loud(n, ch, seed, bits=16):
    """Noise near full scale, clipped to `bits`: a lossy decode overshoots
    the stored width, so the hybrid clip engages."""
    top = 2 ** (bits - 1)
    return np.clip(noise(n, ch, top * 0.7, seed), -top, top - 1)


def _damaged(data, at=200, n=40):
    """`data` with `n` bytes from `at` overwritten: the lanes there hit
    EOF or a sample past their mute limit."""
    data = bytearray(data)
    data[at:at + n] = b"\xff" * n
    return bytes(data)


HYB = dict(hybrid=True, hybrid_bitrate=True, bitrate=300, bitrate_delta=1)

# name -> (.wv bytes, or (.wv, .wvc) bytes; the packed route's width)
CORPUS = {
    "lossless16": (lambda: encode_file(
        noise(1100, 2, 3000, 1), EncodeSpec(block_samples=512, joint=True)),
        2),
    "lossless16_damaged": (lambda: _damaged(encode_file(
        noise(1100, 2, 3000, 2), EncodeSpec(block_samples=256, joint=True))),
        2),
    "mono8": (lambda: encode_file(
        np.clip(noise(600, 1, 30, 3), -128, 127),
        EncodeSpec(block_samples=256, mono=True, bytes_stored=1,
                   terms=(18, 2), deltas=(2, 1))), 1),
    "stereo8_damaged": (lambda: _damaged(encode_file(
        np.clip(noise(900, 2, 40, 4), -128, 127),
        EncodeSpec(block_samples=200, joint=True, bytes_stored=1)), 120),
        1),
    "stereo24_shift": (lambda: encode_file(
        noise(600, 2, 20000, 5) << 3,
        EncodeSpec(block_samples=300, joint=True, bytes_stored=3, shift=3,
                   terms=(17, -1, 5, -2, 3, -3),
                   deltas=(2, 3, 1, 2, 2, 4))), 3),
    "mono24": (lambda: encode_file(
        noise(500, 1, 2**20, 6),
        EncodeSpec(block_samples=200, mono=True, bytes_stored=3)), 3),
    "hybrid16": (lambda: encode_file(
        _loud(600, 2, 7), EncodeSpec(block_samples=300, joint=True,
                                     **HYB)), 2),
    "hybrid_mono": (lambda: encode_file(
        _loud(400, 1, 8), EncodeSpec(block_samples=256, mono=True, **HYB)),
        2),
    "hybrid8": (lambda: encode_file(
        _loud(500, 2, 9, bits=8), EncodeSpec(block_samples=250, joint=True,
                                             bytes_stored=1, **HYB)), 1),
    "hybrid16_damaged": (lambda: _damaged(encode_file(
        _loud(512, 2, 10), EncodeSpec(block_samples=256, joint=True,
                                      **HYB))), 2),
    "float": (lambda: encode_file(
        np.random.default_rng(11).integers(-2**22, 2**22, size=(300, 2)),
        EncodeSpec(block_samples=150, float_data=True, bytes_stored=4,
                   float_shift=0, float_max_exp=127, float_norm_exp=127)),
        None),
    "int32": (lambda: encode_file(
        noise(300, 2, 10**6, 12) << 5,
        EncodeSpec(block_samples=150, bytes_stored=4, int32_mode="zeros",
                   int32_zeros=5)), None),
    "int32_wvx": (lambda: encode_file(
        np.random.default_rng(13).integers(-2**29, 2**29, size=(300, 2)),
        EncodeSpec(block_samples=150, bytes_stored=4, int32_mode="wvx",
                   int32_sent_bits=6)), None),
    "hybrid_wvc": (lambda: _wvc_pair(noise(512, 2, 4000, 14), EncodeSpec(
        block_samples=256, joint=True, wvc=True, **HYB)), None),
}
# the corpora whose payload is packed somewhere: here by the decorrelation
# store's route, or by pack_samples after fixup
DELIVERED = sorted(n for n in CORPUS if n not in ("float", "int32"))


def _wvc_pair(pcm, spec):
    sink = []
    wv = b"".join(encode_blocks(pcm, spec, wvc_sink=sink))
    return wv, b"".join(sink)


def _states(name):
    data = CORPUS[name][0]()
    wvc = None
    if isinstance(data, tuple):
        data, wvc = data
    blocks = parse_blocks(data)
    if wvc is not None:
        assert pair_wvc(blocks, wvc) == len(blocks)
    return [b.state for b in blocks]


@pytest.fixture
def options():
    """Set decode options for one test; the defaults come back after."""
    before = get_options().packed_delivery
    yield set_options
    set_options(packed_delivery=before, delivery_chunk_blocks=0)


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_packed_route_by_profile(name, options):
    """An integer bucket of the plain program (no wvx or wvc stream, not
    int32-expanded) takes the packed route at its delivered width; a
    float, int32, wvx or wvc bucket never does, nor any bucket without
    packed delivery."""
    want = CORPUS[name][1]
    buckets = group_blocks(_states(name))
    for b in buckets:
        assert pipeline.packed_route(b) == want
        if want is not None:
            assert pipeline.packed_route(b) == pipeline.delivery_bps(b)
    options(packed_delivery=False)
    assert all(pipeline.packed_route(b) is None for b in buckets)


def test_mixed_widths_are_not_packed():
    """A bucket whose lanes store 8- and 16-bit samples delivers int32
    samples: no packed width, so no packed route."""
    data = encode_file(np.clip(noise(512, 2, 40, 20), -128, 127),
                       EncodeSpec(block_samples=256, bytes_stored=1)) \
        + encode_file(noise(512, 2, 3000, 21), EncodeSpec(block_samples=256))
    (b,) = group_blocks([x.state for x in parse_blocks(data)])
    assert sorted(set(b.bytes_stored.tolist())) == [0, 1]
    assert pipeline.delivery_bps(b) is None
    assert pipeline.packed_route(b) is None


@pytest.mark.parametrize("name", DELIVERED)
def test_deliver_bucket_payload_unchanged(name):
    """deliver_bucket's payload and CRC/mute table on the CPU equal, byte
    for byte, the chain a bucket took before the packed route:
    decode_tensors' samples through fused.deliver's pack_samples."""
    for b in group_blocks(_states(name)):
        t = bucket_tensors(b, torch.device("cpu"))
        out, crc, mute, crc_x, crc_wvc = pipeline.decode_tensors(b, t)
        want = deliver(out, crc, mute, pipeline.delivery_bps(b),
                       crc_x=crc_x, crc_wvc=crc_wvc)
        got = pipeline.deliver_bucket(b, t)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype and torch.equal(w, g), name
        if name.endswith("damaged"):
            assert got[1][1].any() and not got[1][1].all(), name


def test_fused_decode_refuses_a_packed_float_bucket():
    b = group_blocks(_states("float"))[0]
    t = bucket_tensors(b, torch.device("cpu"))
    prof = b.profile
    base = {k: t[k] for k in pipeline.DEVICE_FIELDS}
    with pytest.raises(ValueError, match="no packed store"):
        fused_decode(**base, mono=prof.mono, hybrid=prof.hybrid,
                     hybrid_bitrate=prof.hybrid_bitrate,
                     hybrid_balance=prof.hybrid_balance, is_float=True,
                     int32_expand=False, nsteps=prof.nsteps, pack_bps=2)


def _mixed_call():
    return (_states("lossless16") + _states("mono8") + _states("float")
            + _states("int32_wvx") + _states("hybrid16_damaged"))


@pytest.mark.parametrize("how", ["one_device", "two_shards", "chunked",
                                 "unpacked"])
def test_decode_counts_lanes_and_packed_lanes(how, options):
    """A traced decode counts every PCM lane it launches in
    `launch#lanes`, and in `launch#packed_lanes` the lanes of the buckets
    packed_route names (0, counted, where none is); shards and chunks
    count each lane once."""
    states = _mixed_call()
    if how == "chunked":
        options(delivery_chunk_blocks=3)
    if how == "unpacked":
        options(packed_delivery=False)
    buckets = group_blocks(states)
    lanes = sum(len(b.states) for b in buckets)
    packed = sum(len(b.states) for b in buckets
                 if pipeline.packed_route(b) is not None)
    assert 0 < packed < lanes or how == "unpacked"
    with trace.collect() as sink:
        if how == "two_shards":
            sharded_decode_states(states, ["cpu", "cpu"])
        else:
            decode_states(states, "cpu")
    assert sink["launch#lanes"] == lanes
    assert sink["launch#packed_lanes"] == (0 if how == "unpacked"
                                           else packed)


def test_kernel_binding_matches_its_c_signature():
    """The ctypes argument types of ops/decorr_cuda.py give the C
    parameters in csrc/decorr.cu of wvpk_decorr_post, and of the cluster
    kernel's CTA count and probe (wvpk_decorr_ctas,
    wvpk_decorr_cluster_probe), pointer for pointer and int for int (a
    mismatch shows only on the card)."""
    src = (Path(decorr_cuda.__file__).parents[1] / "csrc" / "decorr.cu"
           ).read_text()
    names = ("wvpk_decorr_post", "wvpk_decorr_ctas",
             "wvpk_decorr_cluster_probe")

    class Lib:
        pass

    for name in names:
        setattr(Lib, name, type(name, (), {}))
    mp = pytest.MonkeyPatch()
    mp.setattr(decorr_cuda._build, "load", lambda name: Lib)
    try:
        lib = decorr_cuda._lib()
    finally:
        mp.undo()
    import ctypes
    for name in names:
        sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        kinds = ["p" if "*" in p else "i" for p in sig.group(1).split(",")]
        got = ["p" if t is ctypes.c_void_p else "i"
               for t in getattr(lib, name).argtypes]
        assert got == kinds, name
