"""Self-generated WavPack test vectors.

The environment has no wavpack/wvunpack binaries (SURVEY.md env facts), so
tests rely on this minimal encoder producing valid v4/v5 blocks. For
lossless modes the PCM -> .wv -> PCM roundtrip must be the identity, which
makes the encoder an oracle independent of the decoder implementation.
"""

from .encoder import EncodeSpec, encode_file, encode_blocks
from .dsd_encoder import encode_dsd_file
from .multichannel import encode_multichannel

__all__ = ["EncodeSpec", "encode_file", "encode_blocks", "encode_dsd_file",
           "encode_multichannel"]
