"""Output containers (RIFF WAV emission) and PCM byte formatting."""

from .wav import make_wav_header, write_wav
from .pcm import format_samples

__all__ = ["make_wav_header", "write_wav", "format_samples"]
