"""PCM byte formatting (reference WavpackFormatSamples,
WavPackUtils.cs:288-341): int32 samples -> little-endian bytes at 1-4
bytes/sample; 8-bit gets the +128 unsigned offset unless DSD."""

from __future__ import annotations

import numpy as np


def format_samples(samples: np.ndarray, bps: int, dsd: bool = False,
                   float_norm_exp: int | None = None) -> bytes:
    """samples: (n, ch) or flat int32 array in interleaved order.

    float_norm_exp (FLOAT_DATA streams): emit IEEE float32 bytes
    f = v * 2**(norm_exp - 150) instead of integer PCM — the exact
    inverse of the encoder's float grid (encode.py float note), and an
    extension over the reference demo, which always writes integer WAVs
    for float content (WvDemo.cs:74-104). Exact: |v| < 2**24 fits a
    float32 significand and the scale is a power of two."""
    if float_norm_exp is not None:
        flat = np.ascontiguousarray(samples, dtype=np.int32).reshape(-1)
        return (flat.astype(np.float64)
                * 2.0 ** (float_norm_exp - 150)).astype("<f4").tobytes()
    flat = np.ascontiguousarray(samples, dtype=np.int32).reshape(-1)
    if bps == 1:
        if dsd:
            return flat.astype(np.uint8).tobytes()
        return ((flat + 128) & 0xFF).astype(np.uint8).tobytes()
    if bps == 2:
        return flat.astype("<i2", casting="unsafe").tobytes()
    if bps == 3:
        b = flat.astype("<i4").view(np.uint8).reshape(-1, 4)
        return np.ascontiguousarray(b[:, :3]).tobytes()
    if bps == 4:
        return flat.astype("<i4").tobytes()
    raise ValueError(f"bad bytes/sample {bps}")
