"""wvpk_torch's delivery and debug modules on the CPU, against wvpk:
chunked delivery (`delivery_chunk_blocks`) equal to the single fetch on a
mixed PCM + DSD call, the transfer counts (the trace collector's
`launch#h2d_bytes` and `transfer.copy#bytes`), the
oracle check and debug.py, the torch.profiler trace, the sweep's spec
generators and fault injectors (testgen/fuzzspec.py, testgen/faults.py)
with the sweep itself, and the CLI's --report and --verify-checksums.
Inputs are numpy, seeded from fixed numbers; integer codec, so every
comparison is exact."""

import dataclasses
import json

import numpy as np
import pytest

import wvpk.testgen.faults as jax_faults
import wvpk.testgen.fuzzspec as jax_fuzzspec
from wvpk.cli import main as jax_cli_main
from wvpk.container import parse_blocks as jax_parse_blocks
from wvpk.debug import checkify_smoke as jax_checkify_smoke
from wvpk.engine import decode_states as jax_decode_states
from wvpk.testgen import EncodeSpec, encode_dsd_file, encode_file
from wvpk_torch import consts, debug, trace
from wvpk_torch.cli import main as cli_main
from wvpk_torch.config import set_options
from wvpk_torch.container import parse_blocks
from wvpk_torch.engine import decode_states, dsd_pipeline, pipeline, \
    staging
from wvpk_torch.report import DecodeReport
from wvpk_torch.testgen import faults, fuzzspec

from test_torch_pipeline import CORPUS


@pytest.fixture
def options():
    """Set decode options for one test; the defaults come back after."""
    yield set_options
    set_options(delivery_chunk_blocks=0, oracle_check=False)


def noise(n, ch, scale, seed):
    return np.round(np.random.default_rng(seed).normal(0, scale, (n, ch))
                    ).astype(np.int64)


def _mixed_states(parse=parse_blocks):
    """A mixed PCM + DSD call: two lossless chains, a mono, a hybrid and a
    float profile, DSD modes 0, 1 and 3."""
    rng = np.random.default_rng(50)
    data = encode_file(noise(64 * 9, 2, 3000, 51),
                       EncodeSpec(block_samples=64, joint=True))
    data += encode_file(noise(64 * 5, 2, 3000, 52),
                        EncodeSpec(block_samples=64, joint=True,
                                   terms=(17, 17), deltas=(2, 2)))
    data += encode_file(noise(64 * 4, 1, 700, 53),
                        EncodeSpec(block_samples=64, mono=True,
                                   terms=(17, 2), deltas=(2, 2)))
    data += encode_file(noise(64 * 3, 2, 5000, 54),
                        EncodeSpec(block_samples=64, hybrid=True,
                                   bitrate=400))
    data += encode_file(
        rng.integers(-2**22, 2**22, size=(64 * 2, 2)),
        EncodeSpec(block_samples=64, float_data=True, bytes_stored=4,
                   float_shift=0, float_max_exp=127, float_norm_exp=127))
    for mode in (0, 1, 3):
        data += encode_dsd_file(rng.integers(0, 256, (64 * 3, 2)), mode,
                                history_bits=2, block_samples=64)
    return [blk.state for blk in parse(data)]


def _same_blocks(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.samples, w.samples, err_msg=str(k))
        assert (g.crc, g.crc_x, g.mute_error, g.crc_error) \
            == (w.crc, w.crc_x, w.mute_error, w.crc_error), k


def _count_fetches(monkeypatch):
    """Wrap the batched copy: the host bytes of each copy, in order."""
    seen = []
    finish = pipeline._finish_fetch

    def counted(handle):
        out = finish(handle)
        seen.append(sum(a.nbytes for a in out))
        return out

    monkeypatch.setattr(pipeline, "_finish_fetch", counted)
    return seen


def _count_staged(monkeypatch):
    """Wrap the host-to-device copies of buckets and DSD groups: the bytes
    of each."""
    seen = []
    for mod in (staging, dsd_pipeline):
        def counted(arr, device, _to=mod.to_device):
            seen.append(arr.nbytes)
            return _to(arr, device)
        monkeypatch.setattr(mod, "to_device", counted)
    return seen


@pytest.mark.parametrize("ch", [2, 3])
def test_chunked_delivery_equals_single_fetch(ch, options, monkeypatch):
    """With CH 2 and 3 the PCM blocks go in (profile, chain) chunks, one
    copy each, the DSD groups in the last; the blocks equal the single
    fetch's and wvpk's, and the transfer counts equal the bytes staged and
    fetched."""
    states = _mixed_states()
    single = decode_states(states, "cpu")
    _same_blocks(single, jax_decode_states(_mixed_states(jax_parse_blocks)))
    options(delivery_chunk_blocks=ch)
    chunks = pipeline._chunks([st for st in states
                               if not st.flags & consts.DSD_FLAG])
    assert len(chunks) > 1 and max(len(c) for c in chunks) <= ch
    fetched = _count_fetches(monkeypatch)
    staged = _count_staged(monkeypatch)
    with trace.collect() as sink:
        _same_blocks(decode_states(states, "cpu"), single)
    assert len(fetched) == len(chunks)
    assert sink["transfer.copy#bytes"] == sum(fetched)
    assert sink["launch#h2d_bytes"] == sum(staged)


def test_single_fetch_transfer_counts(monkeypatch):
    states = _mixed_states()
    fetched = _count_fetches(monkeypatch)
    staged = _count_staged(monkeypatch)
    with trace.collect() as sink:
        decode_states(states, "cpu")
    assert len(fetched) == 1
    assert (sink["launch#h2d_bytes"], sink["transfer.copy#bytes"]) \
        == (sum(staged), fetched[0])
    # a decode outside a collector counts nowhere, and each collector
    # counts from nothing
    h2d = sum(staged)
    decode_states(states, "cpu")
    assert sink["launch#h2d_bytes"] == h2d and sum(staged) == 2 * h2d
    with trace.collect() as fresh:
        pass
    assert fresh == {} and fresh.spans == []


def test_chunks_follow_profile_and_chain():
    """wvpk's chunking rule: sorted by (profile, chain), cut at each
    profile change and every CH blocks; small calls stay one chunk."""
    states = [st for st in _mixed_states() if not st.flags & consts.DSD_FLAG]
    set_options(delivery_chunk_blocks=4)
    try:
        chunks = pipeline._chunks(states)
    finally:
        set_options(delivery_chunk_blocks=0)
    assert sorted(i for c in chunks for i in c) == list(range(len(states)))
    for c in chunks:
        assert len({staging.profile_of(states[i]) for i in c}) == 1
        chains = [staging._chain_of(states[i]) for i in c]
        assert chains == sorted(chains)
    assert pipeline._chunks(states) == [list(range(len(states)))]
    set_options(delivery_chunk_blocks=len(states))
    try:
        assert len(pipeline._chunks(states)) == 1
    finally:
        set_options(delivery_chunk_blocks=0)


def _tamper(monkeypatch):
    """Every finalized PCM block one sample off."""
    finalize = pipeline.finalize_bucket

    def tampered(*args):
        out = finalize(*args)
        for res in out:
            res.samples = res.samples + 1
        return out

    monkeypatch.setattr(pipeline, "finalize_bucket", tampered)


def test_oracle_check_passes_and_raises_on_a_tampered_result(options,
                                                            monkeypatch):
    states = _mixed_states()
    options(oracle_check=True)
    _same_blocks(decode_states(states, "cpu"),
                 debug.oracle_checked_decode(states, "cpu"))
    _tamper(monkeypatch)
    with pytest.raises(AssertionError, match="oracle mismatch"):
        decode_states(states, "cpu")
    options(oracle_check=False)
    with pytest.raises(AssertionError, match="device/oracle mismatch"):
        debug.oracle_checked_decode(states, "cpu")


def test_oracle_check_raises_on_a_tampered_status(options, monkeypatch):
    """The option and oracle_checked_decode share one check: a block whose
    samples agree but whose status differs from the oracle's raises."""
    states = _mixed_states()
    finalize = pipeline.finalize_bucket

    def tampered(*args):
        out = finalize(*args)
        for res in out:
            res.mute_error = not res.mute_error
        return out

    monkeypatch.setattr(pipeline, "finalize_bucket", tampered)
    options(oracle_check=True)
    with pytest.raises(AssertionError, match="status mismatch"):
        decode_states(states, "cpu")
    options(oracle_check=False)
    with pytest.raises(AssertionError, match="status mismatch"):
        debug.oracle_checked_decode(states, "cpu")


def test_checkify_smoke_equals_wvpk():
    got = debug.checkify_smoke("cpu")
    want = jax_checkify_smoke()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_torch_trace_writes_a_trace(tmp_path):
    with trace.torch_trace(str(tmp_path), device="cpu") as prof:
        debug.checkify_smoke("cpu")
    events = json.loads((tmp_path / "torch_trace.json").read_text())
    assert events["traceEvents"]
    assert len(prof.key_averages()) > 0


def _spec_fields(spec):
    return dataclasses.asdict(spec)


@pytest.mark.parametrize("seed", range(12))
def test_fuzzspec_generators_equal_wvpk(seed):
    """random_spec, random_wvc_spec and random_pcm give wvpk's specs and
    signals from the same seeds (every family forced once, and the
    default mix)."""
    for family in (None, "plain", "int32", "float"):
        rng, jrng = (np.random.default_rng(9000 + seed) for _ in range(2))
        spec = fuzzspec.random_spec(rng, family)
        jspec = jax_fuzzspec.random_spec(jrng, family)
        assert _spec_fields(spec) == _spec_fields(jspec), family
        n = int(rng.integers(100, 400))
        assert n == int(jrng.integers(100, 400))
        np.testing.assert_array_equal(
            fuzzspec.random_pcm(rng, n, spec.nch_data, spec),
            jax_fuzzspec.random_pcm(jrng, n, jspec.nch_data, jspec))
    rng, jrng = (np.random.default_rng(9500 + seed) for _ in range(2))
    spec, jspec = fuzzspec.random_wvc_spec(rng), \
        jax_fuzzspec.random_wvc_spec(jrng)
    assert _spec_fields(spec) == _spec_fields(jspec)
    np.testing.assert_array_equal(
        fuzzspec.random_pcm(rng, 300, spec.nch_data, spec),
        jax_fuzzspec.random_pcm(jrng, 300, jspec.nch_data, jspec))


@pytest.mark.parametrize("mesh", [None, ["cpu", "cpu"]],
                         ids=["unsharded", "mesh2"])
def test_hw_sweep_on_the_cpu(mesh):
    fails, blocks = fuzzspec.run_hw_sweep(n_cases=3, n_dsd=2, n_mc=1,
                                          n_wvc=1, device="cpu", mesh=mesh,
                                          verbose=False)
    assert fails == 0 and blocks > 0


def test_faults_equal_wvpk():
    data = encode_file(noise(900, 2, 3000, 60),
                       EncodeSpec(block_samples=300, joint=True))
    cases = [("flip_bits", (data, [(40, 3), (100, 7)])),
             ("corrupt_block_payload", (data, 1, 5, 3)),
             ("corrupt_header_magic", (data, 2)),
             ("truncate", (data, 0.6)),
             ("prepend_garbage", (data, 97, 4))]
    for name, args in cases:
        got = getattr(faults, name)(*args)
        assert got == getattr(jax_faults, name)(*args), name
        assert got != data, name


TIMING = ("decode_seconds", "msamples_per_s", "realtime_factor",
          "stage_seconds")


def _write(tmp_path, name):
    entry = CORPUS[name]()
    src = tmp_path / f"{name}.wv"
    if isinstance(entry, tuple):
        entry, wvc = entry
        (tmp_path / f"{name}.wvc").write_bytes(wvc)
    src.write_bytes(entry)
    return str(src)


def _report(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    rep = json.loads(out[-1])
    for key in TIMING:
        rep.pop(key)
    return rc, rep


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_cli_report_equals_wvpk(name, tmp_path, capsys):
    src = _write(tmp_path, name)
    rc_want, want = _report(jax_cli_main, [src, "-o", str(tmp_path / "w.wav"),
                                           "-q", "--report"], capsys)
    rc_got, got = _report(cli_main, [src, "-o", str(tmp_path / "g.wav"),
                                     "-q", "--report", "--device", "cpu"],
                          capsys)
    assert set(got) | set(TIMING) == {f.name for f in
                                      dataclasses.fields(DecodeReport)}
    assert (rc_got, got) == (rc_want, want)


def _checksummed(tmp_path):
    """Three files: block checksums of 2 and 4 bytes, one of them with a
    corrupted block, and one with none."""
    files = {}
    for name, width in (("ck2", 2), ("ck4", 4), ("none", 0)):
        files[name] = encode_file(noise(900, 2, 3000, 70 + width),
                                  EncodeSpec(block_samples=300, joint=True,
                                             block_checksum=width))
    bad = bytearray(files["ck4"])
    bad[400] ^= 0x5A
    files["ck4_bad"] = bytes(bad)
    paths = {}
    for name, data in files.items():
        paths[name] = tmp_path / f"{name}.wv"
        paths[name].write_bytes(data)
    return paths


@pytest.mark.parametrize("extra", [[], ["-q"], ["-o", "OUT"]],
                         ids=["audit", "quiet", "with_output"])
@pytest.mark.parametrize("name", ["ck2", "ck4", "none", "ck4_bad"])
def test_cli_verify_checksums_equals_wvpk(name, extra, tmp_path, capsys):
    """--verify-checksums: the same exit code and the same lines as wvpk's
    CLI, alone (audit only) and before a decode."""
    path = str(_checksummed(tmp_path)[name])

    def run(main, out, *more):
        argv = [path, "--verify-checksums"] + [
            str(tmp_path / out) if a == "OUT" else a for a in extra]
        rc = main(argv + list(more))
        got = capsys.readouterr()
        return rc, got.out.replace(out, "OUT"), got.err

    got = run(cli_main, "g.wav", "--device", "cpu")
    want = run(jax_cli_main, "w.wav")
    if extra and extra[0] == "-o":
        # the decode's own lines follow the audit: compare the audit line
        got = got[0], got[1].splitlines()[:1], got[2]
        want = want[0], want[1].splitlines()[:1], want[2]
    assert got == want
    assert got[0] == (1 if name == "ck4_bad" else 0)
