"""wvpk_torch's device encoder on the CPU (the plain versions of the
encode kernels) vs wvpk's (XLA on the CPU): byte-identical blocks on
tests/test_device_encoder.py's families (the mode matrix, warm seeding,
hybrid, wvx, float, multichannel), the same refusals and a round trip
through the port's decoder (the file-level entry points are in
test_torch_encode_files.py). Inputs are numpy, seeded from fixed
numbers."""

import numpy as np
import pytest
import torch

import wvpk.encode as jax_encode
from wvpk.engine.device_encoder import \
    encode_blocks_device as jax_encode_blocks_device
from wvpk.engine.device_encoder import \
    encode_multichannel_device as jax_encode_multichannel_device
from wvpk.testgen.encoder import EncodeSpec as JaxEncodeSpec
from wvpk_torch import encode as port_encode
from wvpk_torch.container import parse_blocks
from wvpk_torch.engine import decode_states
from wvpk_torch.engine.device_encoder import encode_blocks_device, \
    encode_multichannel_device
from wvpk_torch.testgen.encoder import EncodeSpec


def sig(n, ch, seed, scale=5000):
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    return np.round(scale * np.sin(2 * np.pi * t / 89.0)
                    + rng.normal(0, scale / 30, (n, ch))).astype(np.int64)


def noisy(n, ch, seed, scale=6000):
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    return np.clip(np.round(scale * np.sin(2 * np.pi * t / 89.0)
                            + rng.normal(0, scale / 8, (n, ch))),
                   -32768, 32767).astype(np.int64)


def both(pcm, warmup=0, **kw):
    """(wvpk's blocks, the port's blocks) for one spec."""
    want = jax_encode_blocks_device(pcm, JaxEncodeSpec(**kw), warmup=warmup)
    got = encode_blocks_device(pcm, EncodeSpec(**kw), warmup, device="cpu")
    return want, got


def roundtrip(data, pcm):
    """The port's CPU decode of `data` is clean and equals `pcm`."""
    res = decode_states([b.state for b in parse_blocks(data)], "cpu")
    assert not any(r.crc_error or r.mute_error for r in res)
    np.testing.assert_array_equal(np.concatenate([r.samples for r in res]),
                                  pcm)


MODES = ["mono", "nojoint", "neg", "deep", "shift24", "zeros32", "silence",
         "spiky"]


@pytest.mark.parametrize("case", MODES)
def test_mode_matrix_matches_wvpk(case):
    kw = dict(block_samples=256, joint=True, terms=(18, 17, 2),
              deltas=(2, 2, 2))
    pcm = sig(700, 2, 40 + MODES.index(case))
    if case == "mono":
        kw.update(mono=True, joint=False)
        pcm = pcm[:, :1]
    elif case == "nojoint":
        kw.update(joint=False)
    elif case == "neg":
        kw.update(terms=(-2, 17, 3), deltas=(1, 2, 2))
    elif case == "deep":
        kw.update(terms=(18, 18, 17, 17, 3, 2, 5, 1, 2, 18, 17, 2),
                  deltas=(2,) * 12)
    elif case == "shift24":
        kw.update(bytes_stored=3, shift=3)
        pcm = (pcm * 40) << 3
    elif case == "zeros32":
        kw.update(bytes_stored=4, int32_mode="zeros", int32_zeros=5)
        pcm = (pcm << 5)
    elif case == "silence":
        pcm[100:600] = 0
    elif case == "spiky":
        pcm[:] = 0
        pcm[::61] = 9000
    want, got = both(pcm, **kw)
    assert got == want
    if case in ("neg", "silence"):
        roundtrip(b"".join(got), pcm)


@pytest.mark.parametrize("warmup", [0, 512])
@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
def test_warm_seeding_matches_wvpk(warmup, mono):
    """The warm scan (the invert with its final state, rings rotated and
    quantized into the seeds) and the fresh seeds, on the "high" chain;
    700 samples at 256 a block: the last block is short."""
    pcm = sig(700, 1 if mono else 2, 50 + mono)
    spec = jax_encode.build_spec(pcm, block_samples=256, preset="high",
                                 md5=False)
    want = jax_encode_blocks_device(pcm, spec, warmup=warmup)
    pspec = port_encode.build_spec(pcm, block_samples=256, preset="high",
                                   md5=False)
    assert encode_blocks_device(pcm, pspec, warmup, device="cpu") == want


HYBRID = ["stereo", "mono", "balance", "nobitrate", "silence"]


@pytest.mark.parametrize("case", HYBRID)
def test_hybrid_matches_wvpk(case):
    mono = case == "mono"
    pcm = noisy(700, 1 if mono else 2, 60 + HYBRID.index(case))
    if case == "silence":
        pcm[:] = 0
    kw = dict(block_samples=256, mono=mono, joint=not mono,
              terms=(18, 2) if mono else (18, 17, 2),
              deltas=(2, 2) if mono else (2, 2, 2), hybrid=True,
              hybrid_bitrate=case != "nobitrate",
              hybrid_balance=case == "balance", bitrate=420, md5=False)
    want, got = both(pcm, warmup=256, **kw)
    assert got == want


def test_hybrid_multichannel_matches_wvpk():
    pcm = noisy(600, 6, 70)
    kw = dict(block_samples=256, joint=True, terms=(18, 17, 2),
              deltas=(2, 2, 2), hybrid=True, hybrid_bitrate=True,
              bitrate=512, md5=False)
    want = jax_encode_multichannel_device(pcm, JaxEncodeSpec(**kw))
    assert encode_multichannel_device(pcm, EncodeSpec(**kw),
                                      device="cpu") == want


def wide(mono=False, false_stereo=False):
    pcm = (sig(700, 2, 80) * (1 << 14)).astype(np.int64) | 1
    if mono:
        return pcm[:, :1]
    if false_stereo:
        return np.repeat(pcm[:, :1], 2, axis=1)
    return pcm


ENCODE_DEVICE = {
    "lossless_default": lambda: (sig(700, 2, 81), dict(block_samples=256)),
    "lossless_high_md5": lambda: (sig(700, 2, 82),
                                  dict(block_samples=256, preset="high")),
    "hybrid": lambda: (noisy(700, 2, 83),
                       dict(block_samples=256, hybrid=True, bitrate=512)),
    "wvx_stereo": lambda: (wide(), dict(block_samples=256,
                                        bytes_per_sample=4)),
    "wvx_mono": lambda: (wide(mono=True), dict(block_samples=256,
                                               bytes_per_sample=4)),
    "wvx_false_stereo": lambda: (wide(false_stereo=True),
                                 dict(block_samples=256,
                                      bytes_per_sample=4)),
    "float": lambda: ((sig(700, 2, 84) / 65536.0).astype(np.float32),
                      dict(block_samples=256)),
    "multichannel_5ch": lambda: (sig(600, 5, 85),
                                 dict(block_samples=256, preset="high")),
    "checksum": lambda: (sig(700, 2, 86),
                         dict(block_samples=256, block_checksum=4)),
}


@pytest.mark.parametrize("name", sorted(ENCODE_DEVICE))
def test_encode_device_matches_wvpk(name):
    pcm, kw = ENCODE_DEVICE[name]()
    want = jax_encode.encode_device(pcm, **kw)
    assert port_encode.encode_device(pcm, device="cpu", **kw) == want


REFUSED = {
    "hybrid_float": (lambda: noisy(100, 2, 1), dict(
        block_samples=100, hybrid=True, hybrid_bitrate=True,
        float_data=True)),
    "stored_2_27": (lambda: np.full((100, 2), 1 << 27, np.int64),
                    dict(block_samples=100, bytes_stored=4)),
}


@pytest.mark.parametrize("name", sorted(REFUSED) + ["wvc"])
def test_refusals_match_wvpk(name):
    """The port's device encoder refuses what wvpk's refuses, with a
    ValueError: hybrid float content, a correction file, stored values
    of 2^27 and more."""
    if name == "wvc":
        calls = [lambda: jax_encode.encode_device(
                     noisy(100, 2, 2), hybrid=True, wvc=True),
                 lambda: port_encode.encode_device(
                     noisy(100, 2, 2), hybrid=True, wvc=True, device="cpu")]
    else:
        pcm, kw = REFUSED[name]
        calls = [lambda: jax_encode_blocks_device(pcm(), JaxEncodeSpec(**kw)),
                 lambda: encode_blocks_device(pcm(), EncodeSpec(**kw),
                                              device="cpu")]
    for call in calls:
        with pytest.raises(ValueError):
            call()


def test_encode_device_decodes_in_the_port(tmp_path):
    """A hybrid device encode decodes cleanly in the port (the lossless
    ones are held sample-exact above), and the default device of both
    device entry points is the card."""
    hyb = port_encode.encode_device(noisy(700, 2, 96), device="cpu",
                                    hybrid=True, bitrate=400,
                                    block_samples=256)
    res = decode_states([b.state for b in parse_blocks(hyb)], "cpu")
    assert not any(r.crc_error or r.mute_error for r in res)
    import inspect
    for fn in (port_encode.encode_device, port_encode.encode_wav_file):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("hybrid", [False, True], ids=["lossless", "hybrid"])
def test_payload_overflow_raises(monkeypatch, hybrid):
    """A payload longer than the words the packer writes into is an
    error, never a silently cut block."""
    from wvpk_torch.ops import encode_pack

    monkeypatch.setattr(encode_pack, "payload_cap", lambda nwords: 2)
    with pytest.raises(RuntimeError, match="overflows its capacity"):
        port_encode.encode_device(noisy(300, 2, 95), device="cpu",
                                  block_samples=256, hybrid=hybrid)


@pytest.mark.parametrize("hybrid", [False, True], ids=["lossless", "hybrid"])
@pytest.mark.parametrize("preset,mono", [(p, m) for p in ("fast", "default",
                                                          "high")
                                         for m in (False, True)])
def test_device_encoder_names_the_spec_chain_to_the_invert(
        monkeypatch, preset, mono, hybrid):
    """The device encoder hands each invert call its spec's chain as
    static_terms (every lane carries it), as wvpk's device encoder does at
    both of its calls: a lossless encode the warm seeding scan (with its
    final state) and the main invert, a hybrid encode the warm one only
    (the hybrid scan inverts for itself). The chain runs its compiled
    kernel on the card unless it is mono with cross terms."""
    from wvpk_torch.encode import build_spec
    from wvpk_torch.engine import device_encoder as de
    from wvpk_torch.ops.decorr_cuda import GENERIC, lane_runs
    from wvpk_torch.ops.encode_select import invert_any

    seen = []

    def spy(*args, static_terms=None, with_state=False, **kw):
        seen.append((static_terms, with_state))
        return invert_any(*args, static_terms=static_terms,
                          with_state=with_state, **kw)

    monkeypatch.setattr(de, "invert_any", spy)
    rng = np.random.default_rng(17)
    pcm = np.round(rng.normal(0, 900, (700, 1 if mono else 2))).astype(
        np.int64)
    opts = dict(hybrid=True, bitrate=400) if hybrid else {}
    spec = build_spec(pcm, block_samples=256, preset=preset, **opts)
    de.scan_lanes(de.stage_lanes(pcm, spec, 64, torch.device("cpu")))
    chain = tuple(spec.terms)
    assert len(chain) > 0
    assert seen == [(chain, True)] + ([] if hybrid else [(chain, False)])
    assert (lane_runs(3, mono, chain)[0][0] == GENERIC) == (
        mono and any(t < 0 for t in chain))
