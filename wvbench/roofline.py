"""The yardstick of the kernels' rooflines: the card's peak and the bytes
each call must move, counted from the data, never from a kernel's
arguments, so that every implementation is held to the same work.

Each input byte is read once and each output byte written once:
- decode: the blocks' `.wv` payload bytes and the PCM at its delivered
  width (bytes per sample x channels x frames);
- encode: the source PCM at 2 bytes a channel sample, and the `.wv`
  bytes produced.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes/s (at the 700 W limit)
PEAK_HBM_BYTES_S = 3.35e12


def decode_bytes(wv_payload: int, frames: int, channels: int,
                 bytes_per_sample: int) -> int:
    """Bytes one decoded file moves at least."""
    return wv_payload + frames * channels * bytes_per_sample


def encode_bytes(frames: int, channels: int, bytes_per_sample: int,
                 wv_bytes: int) -> int:
    """Bytes one encoded file moves at least."""
    return frames * channels * bytes_per_sample + wv_bytes


def roofline_pct(nbytes: int, kernel_s: float) -> float | None:
    """The least time the bytes take at the peak, as a share of the
    kernels' summed device time; None without device time."""
    if not kernel_s > 0:
        return None
    return 100.0 * (nbytes / PEAK_HBM_BYTES_S) / kernel_s
