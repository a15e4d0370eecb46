"""wvpk_torch: the wvpk decoder in PyTorch, with hand-written CUDA kernels.

A port of `wvpk` (JAX) beside it. This package imports `torch` and never
`jax`; the jax-free host layers of `wvpk` (container, io, ref, testgen,
native, consts, tables, config) are imported as they are.

Slice covered: batch decode of every PCM mode: lossless integer PCM
(8/16/24/32-bit, mono or stereo blocks, any decorrelation term chain,
joint stereo, shift, int32 zeros/ones/dups), hybrid lossy (with
HYBRID_BITRATE and HYBRID_BALANCE), hybrid with its .wvc correction file
(lossless), float, and int32 with a wvx stream. Every function takes an
explicit `device`: on "cpu" the plain PyTorch versions run, on "cuda" the
kernels in `csrc/` run (built with nvcc at first use). DSD blocks raise
NotImplementedError naming their ROADMAP slice.
"""
