"""PCM byte packing on the device (port of wvpk/ops/pack.py).

int32 samples -> the little-endian PCM byte stream of each lane, packed
into 32-bit words: bps 1 (with the +128 offset of 8-bit WAV), 2, 3 and 4
bytes per sample (reference WavPackUtils.cs:288-341). Packing on the
device shrinks the device-to-host copy to the PCM payload's width.
"""

from __future__ import annotations

import torch

from .bitio import wrap32


def pack_samples(samples, *, bps: int):
    """samples: (T, L, C) int32 -> (L, W) int32 words (uint32 bit
    patterns) of packed little-endian bytes, in interleaved (sample,
    channel) order. T * C * bps must be a multiple of 4."""
    T, L, C = samples.shape
    n = T * C
    vals = samples.permute(1, 0, 2).reshape(L, n).to(torch.int64)
    if bps == 1:
        b = ((vals + 128) & 0xFF).reshape(L, n // 4, 4)
        out = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) \
            | (b[..., 3] << 24)
    elif bps == 2:
        v = (vals & 0xFFFF).reshape(L, n // 2, 2)
        out = v[..., 0] | (v[..., 1] << 16)
    elif bps == 3:
        if n % 4:
            raise ValueError("3-byte pack needs a multiple of 4 values")
        v = (vals & 0xFFFFFF).reshape(L, n // 4, 4)
        w0 = v[..., 0] | ((v[..., 1] << 24) & 0xFFFFFFFF)
        w1 = (v[..., 1] >> 8) | ((v[..., 2] << 16) & 0xFFFFFFFF)
        w2 = (v[..., 2] >> 16) | (v[..., 3] << 8)
        out = torch.stack([w0, w1, w2], dim=2)
    elif bps == 4:
        out = vals
    else:
        raise ValueError(f"bad bytes/sample {bps}")
    return wrap32(out).to(torch.int32).reshape(L, -1)
