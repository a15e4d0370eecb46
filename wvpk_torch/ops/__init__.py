"""Decode operations on tensors (port of wvpk/ops).

Layout follows wvpk: lanes are blocks, samples run along the scan axis,
per-sample tensors are (T, L, C). Each module holding a kernel has a plain
PyTorch version beside it; the `*_select` modules dispatch on the tensor's
device: CPU tensors take the plain version, CUDA tensors the kernel.
"""
