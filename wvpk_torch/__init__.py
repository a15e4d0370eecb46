"""wvpk_torch: the wvpk decoder in PyTorch, with hand-written CUDA kernels.

A port of `wvpk` (JAX) beside it. This package imports `torch` and never
`jax`, and nothing of `wvpk`: it carries its own copies of wvpk's host
layers (consts, tables, config, trace, container, io, native, ref,
testgen), kept in step with the originals by the tests.

Slice covered: batch decode of every kind of .wv file: lossless integer
PCM (8/16/24/32-bit, mono or stereo blocks, any decorrelation term chain,
joint stereo, shift, int32 zeros/ones/dups), hybrid lossy (with
HYBRID_BITRATE and HYBRID_BALANCE), hybrid with its .wvc correction file
(lossless), float, int32 with a wvx stream, and DSD (modes 0, 1 and 3).
Every function takes an explicit `device`: on "cpu" the plain PyTorch
versions run, on "cuda" the kernels in `csrc/` run (built with nvcc at
first use).
"""
