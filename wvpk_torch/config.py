"""Decode options (SURVEY.md section 5.6, open-level layer).

The WavPack format's other two config layers are decoded elsewhere: the
32-bit header flags bitfield drives all decode branches (consts.py,
container/blockstate.py) and CONFIG_* metadata feeds the informational
mode mask (api.get_mode). This module is the open-level layer — the
reference has only OPEN_2CH_MAX (Defines.cs:26); ours adds the batch /
layout / debug knobs the batched engine needs. The kernels are chosen by the
tensors' device (ops/*_select.py), so no option selects one.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class DecodeOptions:
    # how many upcoming segments one lazy API decode batches together
    batch_blocks: int = 256
    # decoded-segment cache cap (insertion-order eviction); bounds API
    # memory to O(cache_segments x block) on arbitrarily long files
    cache_segments: int = 1024
    # path sources at least this many bytes open in streaming mode
    # (header index eager, payload parse lazy, bounded caches)
    stream_threshold: int = 64 << 20
    # lane capacity rounding floor (power-of-two bucketing of block sizes)
    capacity_floor: int = 256
    # cross-check every decoded block against the scalar oracle at the end
    # of decode_states (slow; debugging)
    oracle_check: bool = False
    # deliver PCM from the device as packed bytes (bytes_stored+1 wide)
    # instead of int32 samples when the bucket allows it: 2-4x smaller
    # device->host transfers on the API/CLI delivery path
    packed_delivery: bool = True
    # pipeline the delivery path in chunks of at most this many PCM blocks
    # (one (profile, chain) run each): chunk k+1 stages and launches while
    # chunk k's results copy to the host. 0 = one batched copy per call,
    # the default (wvpk's)
    delivery_chunk_blocks: int = 0


_default = DecodeOptions()


def get_options() -> DecodeOptions:
    return _default


def set_options(**kwargs) -> DecodeOptions:
    global _default
    _default = replace(_default, **kwargs)
    return _default
