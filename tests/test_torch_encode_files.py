"""wvpk_torch's file-level encode entry points on the CPU (the plain
versions of the encode kernels) vs wvpk's: `encode_wav_file` on the
device encoder over block-aligned window splits, and the CLI's encode
mode (device encoder, and the host encoder for `--wvc` and .dsf inputs).
Inputs are numpy, seeded from fixed numbers."""

from pathlib import Path

import numpy as np
import pytest

import wvpk.cli as jax_cli
import wvpk.encode as jax_encode
from wvpk_torch import cli as port_cli
from wvpk_torch import encode as port_encode

from test_torch_device_encoder import noisy, roundtrip, sig


def _wav(tmp_path, pcm, bits=16, name="in.wav"):
    from wvpk_torch.io.wav import make_wav_header

    nb = bits // 8
    data = make_wav_header(len(pcm), pcm.shape[1], 44100, bits, nb) \
        + pcm.astype(f"<i{nb}").tobytes()
    path = tmp_path / name
    path.write_bytes(data)
    return path


@pytest.mark.parametrize("window,ch", [(256, 2), (512, 2), (512, 5)],
                         ids=["one_block", "two_blocks", "multichannel"])
def test_encode_wav_file_windows_match_wvpk(tmp_path, window, ch):
    """encode_wav_file on the device encoder: any block-aligned window
    split gives wvpk's bytes (and the whole-file encode_device's)."""
    pcm = sig(600, ch, 90 + ch)
    src = _wav(tmp_path, pcm)
    kw = dict(block_samples=256, window_samples=window)
    jax_encode.encode_wav_file(str(src), str(tmp_path / "want.wv"),
                               device=True, **kw)
    info = port_encode.encode_wav_file(str(src), str(tmp_path / "got.wv"),
                                       device="cpu", **kw)
    got = (tmp_path / "got.wv").read_bytes()
    assert got == (tmp_path / "want.wv").read_bytes()
    assert info["windows"] == -(-600 // window)
    if window == 512 and ch == 2:
        whole = str(tmp_path / "whole.wv")
        port_encode.encode_wav_file(str(src), whole, device="cpu",
                                    block_samples=256)
        assert Path(whole).read_bytes() == got
        roundtrip(got, pcm)


def _dsf(tmp_path):
    from wvpk_torch.io.dsf import make_dsf

    data = np.random.default_rng(97).integers(0, 256, (3000, 2)) \
        .astype(np.uint8)
    path = tmp_path / "in.dsf"
    path.write_bytes(make_dsf(data, 2822400))
    return path


CLI = {
    # (port flags, wvpk flags): wvpk's --device runs its device encoder
    "device": (["--device", "cpu"], ["--device"]),
    "hybrid_wvc": (["--device", "cpu", "--hybrid-bitrate", "400", "--wvc"],
                   ["--hybrid-bitrate", "400", "--wvc"]),
    "dsf": (["--device", "cpu", "--dsd-mode", "1"], ["--dsd-mode", "1"]),
}


@pytest.mark.parametrize("name", sorted(CLI))
def test_cli_encode_matches_wvpk(tmp_path, name):
    port_flags, jax_flags = CLI[name]
    src = _dsf(tmp_path) if name == "dsf" else _wav(tmp_path,
                                                    noisy(700, 2, 98))
    common = ["--encode", "-q", "--block-samples", "256", str(src)]
    assert port_cli.main(common + ["-o", str(tmp_path / "got.wv"),
                                   *port_flags]) == 0
    assert jax_cli.main(common + ["-o", str(tmp_path / "want.wv"),
                                  *jax_flags]) == 0
    assert (tmp_path / "got.wv").read_bytes() \
        == (tmp_path / "want.wv").read_bytes()
    if name == "hybrid_wvc":
        assert (tmp_path / "got.wvc").read_bytes() \
            == (tmp_path / "want.wvc").read_bytes()
