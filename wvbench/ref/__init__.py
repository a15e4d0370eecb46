"""The benchmark's plain reference: a frozen scalar WavPack decoder in
Python and NumPy (`oracle.unpack_samples`) with its own container parse.
Imports neither jax, wvpk nor wvpk_torch."""
