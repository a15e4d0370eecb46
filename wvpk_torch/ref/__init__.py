"""Scalar CPU oracle decoder (golden model for the TPU pipeline)."""

from .oracle import OracleBitstream, WordsState, decode_block, unpack_samples

__all__ = ["OracleBitstream", "WordsState", "decode_block", "unpack_samples"]
