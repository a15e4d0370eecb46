"""wvx injection dispatch by tensor device.

CPU tensors take the plain PyTorch version (post.py::wvx_inject), CUDA
tensors the kernel (wvx_cuda.py). There is no option and no fallback
between them. The rest of post.py (joint/mute/CRC, fixup) needs no
dispatch: the CRC step is folded into the decorrelation kernel, and fixup
is elementwise PyTorch on either device.
"""

from __future__ import annotations

from .post import wvx_inject
from .wvx_cuda import wvx_inject_cuda


def wvx_inject_any(out, nsamples, wvx_words, wvx_start_bit, wvx_start_bc,
                   sent_bits, max_width, int32_zod, false_stereo=None):
    """Returns (out' (T, L, C) int32, crc_x (L,) int32)."""
    if out.is_cuda:
        fn = wvx_inject_cuda
    elif out.device.type == "cpu":
        fn = wvx_inject
    else:
        raise ValueError(f"no wvx injection for device {out.device}")
    return fn(out, nsamples, wvx_words, wvx_start_bit, wvx_start_bc,
              sent_bits, max_width, int32_zod, false_stereo)
