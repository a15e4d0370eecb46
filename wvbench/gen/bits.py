"""LSB-first bit writer for the test-vector encoder.

Frozen copy for the benchmark, taken from wvpk_torch/testgen/bits.py: the yardstick does not follow
later changes to the program, and imports nothing of it.
"""

from __future__ import annotations


class BitWriter:
    def __init__(self):
        self._bits: list[int] = []

    def putbit(self, b: int) -> None:
        self._bits.append(b & 1)

    def putbits(self, value: int, nbits: int) -> None:
        for k in range(nbits):
            self._bits.append((value >> k) & 1)

    def put_unary_ones(self, n: int) -> None:
        """n one-bits followed by a terminating zero."""
        self._bits.extend([1] * n)
        self._bits.append(0)

    def put_gamma(self, v: int) -> None:
        """The WavPack Elias-style escape code (WordsUtils.cs:321-335):
        unary cbits then cbits-1 low bits with an implicit top bit."""
        if v < 2:
            self.put_unary_ones(v)
        else:
            c = v.bit_length()
            self.put_unary_ones(c)
            self.putbits(v, c - 1)  # top bit implicit

    def bit_length(self) -> int:
        return len(self._bits)

    def getvalue(self) -> bytes:
        out = bytearray((len(self._bits) + 7) // 8)
        for i, b in enumerate(self._bits):
            if b:
                out[i >> 3] |= 1 << (i & 7)
        return bytes(out)
