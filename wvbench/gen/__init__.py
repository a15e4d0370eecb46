"""The benchmark's input generator: stereo CD audio synthesised from a
seed (`synth`) and a frozen copy of the port's host test encoder
(`encoder`, with its C hot path in `csrc/wvpk_encode.c`). Imports neither
jax, wvpk nor wvpk_torch."""
