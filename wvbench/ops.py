"""What one call of a cell does: the entry the window drives.

`decode`: the path of `wvpk_torch.cli.decode_batch` without writing WAV
files: `container.parse_blocks` per file, one `engine.decode_states` for
the batch at the default
options, and each file's samples joined in block order. It returns each
file's (frames, channels) int32 PCM and the count of blocks whose status
says CRC error or mute.

`encode`: one `encode.encode_device` over a track; it returns the `.wv`
bytes.

The program is looked up at each call (`engine.decode_states`, not a
name bound at import), so a test can break it underneath.
"""

from __future__ import annotations

import numpy as np

from . import roofline


def decode(files, device, spans):
    from wvpk_torch import container, engine

    counts, states = [], []
    with spans("parse"):
        for f in files:
            blocks = container.parse_blocks(f.wv)
            counts.append(len(blocks))
            states.extend(b.state for b in blocks)
    with spans("decode_states"):
        results = engine.decode_states(states, device)
    with spans("join"):
        outs, bad, pos = [], 0, 0
        for n in counts:
            got = [r for r in results[pos:pos + n] if r is not None]
            pos += n
            outs.append(np.concatenate([r.samples for r in got])
                        if got else np.zeros((0, 2), np.int32))
            bad += sum(1 for r in got if r.crc_error or r.mute_error)
    return outs, bad


def encode(files, device, spans, options: dict):
    from wvpk_torch.encode import encode_device

    outs = []
    with spans("encode"):
        for f in files:
            outs.append(encode_device(f.pcm, device=device, **options))
    return outs


def frames(files) -> int:
    """The frames a call delivers or encodes: the block headers' count
    (the generator's file lengths)."""
    return sum(f.frames for f in files)


def call_bytes(op: str, files, outs, config: dict) -> int:
    """The bytes a call must move (roofline.py)."""
    bps = config["bits_per_sample"] // 8
    ch = config["channels"]
    if op == "decode":
        return sum(roofline.decode_bytes(f.payload, f.frames, ch, bps)
                   for f in files)
    return sum(roofline.encode_bytes(f.frames, ch, bps, len(out))
               for f, out in zip(files, outs))


def plan(rng, pool_files: int, per_call: int):
    """Calls forever: each pass over the pool is a permutation drawn
    from `rng`, cut into calls of `per_call` files."""
    while True:
        perm = rng.permutation(pool_files)
        for i in range(0, pool_files, per_call):
            yield [int(x) for x in perm[i:i + per_call]]
