"""Batched decode engine: block staging and the bucket pipeline."""

from .pipeline import DecodedBlock, decode_bytes, decode_states

__all__ = ["DecodedBlock", "decode_states", "decode_bytes"]
