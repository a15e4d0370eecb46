"""Structured decode reports (SURVEY.md section 5.5; port of
wvpk/report.py, on the port's api).

The reference's observability is an error_message string plus a console
dump (WavpackContext.cs:19, WvDemo.cs:58-68). Here: a structured per-file
report (mode mask, stream geometry, crc/mute tallies, throughput, stage
timings) serializable to JSON, plus standard `logging` integration.
"""

from __future__ import annotations

import json
import logging
from dataclasses import asdict, dataclass, field


log = logging.getLogger("wvpk_torch")


@dataclass
class DecodeReport:
    file: str = ""
    mode_mask: int = 0
    lossless: bool = False
    num_channels: int = 0
    sample_rate: int = 0
    bits_per_sample: int = 0
    total_samples: int = 0
    blocks: int = 0
    segments: int = 0
    crc_errors: int = 0
    mute_blocks: int = 0
    # hybrid-lossless pairing (beyond parity): blocks that decoded with
    # a wvc correction stream attached
    wvc_paired: int = 0
    decode_seconds: float = 0.0
    msamples_per_s: float = 0.0
    realtime_factor: float = 0.0
    stage_seconds: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    def emit(self, level: int = logging.INFO) -> None:
        log.log(level, "decode report: %s", self.to_json())


def build_report(wpc, *, file: str = "", decode_seconds: float = 0.0,
                 samples_decoded: int = 0,
                 stage_seconds: dict | None = None) -> DecodeReport:
    from . import api

    mode = api.WavpackGetMode(wpc)
    rate = api.WavpackGetSampleRate(wpc)
    secs = max(decode_seconds, 1e-12)
    return DecodeReport(
        file=file,
        mode_mask=mode,
        lossless=not api.WavpackLossy(wpc),
        num_channels=api.WavpackGetNumChannels(wpc),
        sample_rate=rate,
        bits_per_sample=api.WavpackGetBitsPerSample(wpc),
        total_samples=api.WavpackGetNumSamples(wpc, native=True),
        blocks=len(wpc.blocks),
        segments=len(wpc._segments),
        crc_errors=wpc.crc_errors,
        mute_blocks=wpc.mute_blocks,
        wvc_paired=wpc.wvc_paired,
        decode_seconds=decode_seconds,
        msamples_per_s=samples_decoded / secs / 1e6,
        realtime_factor=(samples_decoded / rate) / secs if rate else 0.0,
        stage_seconds=dict(stage_seconds or {}),
    )
