"""Edge streams for the entropy decoder: one bucket of one profile whose
lanes take every path of get_words (WordsUtils.cs:272-511).

No counterpart in wvpk.testgen. Each lane is a one-block file of
EDGE_SAMPLES samples, encoded with this package's encoder and parsed back;
the lanes cycle through the kinds of EDGE_KINDS, with amplitudes that give
words of 2 to 30 bits, so words straddle the 32-bit refills of a bit reader
at every offset:

- `noise`: Gaussian noise, amplitude 2^3 .. 2^14 by lane;
- `zero_runs`: silence with short bursts and zero initial medians (zero
  runs and their Elias-gamma lengths);
- `spikes`: small noise with rare full-scale spikes (LIMIT_ONES escapes);
- `truncated`: noise whose payload is cut short, so the lane reads the
  0xff EOF fill (an EOF break, `broke`, and a short `ndec`);
- `corrupted`: noise with a run of payload bytes overwritten by random
  bytes;
- `zero_filled`: noise whose payload tail is zero bytes (long unary zeros
  past the real words).

The profiles of EDGE_PROFILES are the entropy kernel's: lossless and
hybrid (plain, HYBRID_BITRATE, HYBRID_BALANCE), stereo and mono, and
hybrid with its .wvc (the `wvc=True` outputs).
"""

from __future__ import annotations

import numpy as np

from ..container import parse_blocks
from ..container.blocks import pair_wvc
from .encoder import EncodeSpec, encode_blocks

EDGE_SAMPLES = 512
EDGE_KINDS = ("noise", "zero_runs", "spikes", "truncated", "corrupted",
              "zero_filled")
_HYB = dict(hybrid=True, hybrid_bitrate=True, bitrate=300, bitrate_delta=1)
EDGE_PROFILES = {
    "lossless": dict(joint=True),
    "lossless_mono": dict(mono=True, terms=(18, 2), deltas=(2, 2)),
    "hybrid": dict(joint=True, hybrid=True, bitrate=500),
    "hybrid_bitrate": dict(joint=True, **_HYB),
    "hybrid_balance": dict(joint=True, hybrid_balance=True, **_HYB),
    "hybrid_mono": dict(mono=True, terms=(18, 2), deltas=(2, 2), **_HYB),
    "wvc": dict(joint=True, wvc=True, **_HYB),
    "wvc_mono": dict(mono=True, terms=(18, 2), deltas=(2, 2), wvc=True,
                     **_HYB),
}


def _pcm(kind: str, lane: int, ch: int, rng) -> np.ndarray:
    n = EDGE_SAMPLES
    if kind == "zero_runs":
        pcm = np.zeros((n, ch))
        for at in rng.integers(0, n - 16, 3):
            pcm[at:at + 12] = rng.normal(0, 40, (12, ch))
    elif kind == "spikes":
        pcm = rng.normal(0, 4, (n, ch))
        hit = rng.random((n, ch)) < 0.02
        pcm[hit] = rng.choice([-32000, 32000], int(hit.sum()))
    else:
        pcm = rng.normal(0, 2.0 ** (3 + lane % 12), (n, ch))
    return np.clip(np.round(pcm), -32768, 32767).astype(np.int64)


def _damage(kind: str, wvbits: bytes, rng) -> bytes:
    data = bytearray(wvbits)
    n = len(data)
    if kind == "truncated":
        return bytes(data[:int(rng.integers(n // 4, 3 * n // 4))])
    if kind == "corrupted" and n > 8:
        at = int(rng.integers(0, n - 8))
        data[at:at + 8] = rng.integers(0, 256, 8).astype(np.uint8).tobytes()
    if kind == "zero_filled":
        at = int(rng.integers(n // 2, n))
        data[at:] = bytes(n - at)
    return bytes(data)


def edge_states(profile: str, lanes: int = 64, seed: int = 0) -> list:
    """Block states of `lanes` one-block files of `profile`
    (EDGE_PROFILES), lane i of kind EDGE_KINDS[i % 6]; their payloads
    damaged as the kind says, the .wvc of a wvc profile paired."""
    opts = EDGE_PROFILES[profile]
    ch = 1 if opts.get("mono") else 2
    rng = np.random.default_rng(seed)
    states = []
    for i in range(lanes):
        kind = EDGE_KINDS[i % len(EDGE_KINDS)]
        spec = EncodeSpec(
            block_samples=EDGE_SAMPLES,
            initial_medians=((0, 0, 0), (0, 0, 0)) if kind == "zero_runs"
            else None, **opts)
        sink = [] if spec.wvc else None
        blocks = parse_blocks(b"".join(encode_blocks(
            _pcm(kind, i, ch, rng), spec, wvc_sink=sink)))
        if sink is not None:
            pair_wvc(blocks, b"".join(sink))
        (st,) = [b.state for b in blocks]
        st.wvbits = _damage(kind, st.wvbits or b"", rng)
        states.append(st)
    return states
