"""DSD decode dispatch by tensor device (the port's counterpart of
wvpk/engine/dsd_pipeline.py's `_use_pallas_dsd` choice).

CPU tensors take the plain PyTorch versions (dsd.py), CUDA tensors the
kernels (dsd_cuda.py). There is no option and no fallback between them.
Both deliver the byte-values as each lane's uint8 row. The mode-0 CRC
(dsd.py::dsd_raw_crc) is tensor ops on either device.
"""

from __future__ import annotations

from .dsd import dsd_fast_decode_bytes, dsd_high_decode_bytes
from .dsd_cuda import dsd_fast_decode_cuda, dsd_high_decode_cuda


def _on_cuda(t) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no DSD decoder for device {t.device}")
    return False


def dsd_fast_decode_any(data, nbytes, summed, value0, nvals, *, bins: int,
                        mono: bool, nsteps: int):
    """Mode 1: returns (out (L, nsteps) uint8, err (L,) bool, crc (L,))."""
    fn = dsd_fast_decode_cuda if _on_cuda(data) else dsd_fast_decode_bytes
    return fn(data, nbytes, summed, value0, nvals, bins=bins, mono=mono,
              nsteps=nsteps)


def dsd_high_decode_any(data, nbytes, ptable0, filters0, value0, nsamples,
                        *, mono: bool, nsteps: int):
    """Mode 3: returns (out (L, nsteps * C) uint8, crc (L,) int32)."""
    fn = dsd_high_decode_cuda if _on_cuda(data) else dsd_high_decode_bytes
    return fn(data, nbytes, ptable0, filters0, value0, nsamples, mono=mono,
              nsteps=nsteps)
