"""wvpk_torch: the wvpk decoder in PyTorch, with hand-written CUDA kernels.

A port of `wvpk` (JAX) beside it. This package imports `torch` and never
`jax`; the jax-free host layers of `wvpk` (container, io, ref, testgen,
native, consts, tables, config) are imported as they are.

Slice covered: batch decode of lossless integer PCM (8/16/24/32-bit, mono
or stereo blocks, any decorrelation term chain, joint stereo, shift).
Every function takes an explicit `device`: on "cpu" the plain PyTorch
versions run, on "cuda" the kernels in `csrc/` run (built with nvcc at
first use). Hybrid, float, int32+wvx, wvc and DSD blocks raise
NotImplementedError naming their ROADMAP slice.
"""
