"""Randomized mode-matrix spec/signal generators + differential sweep
(copy of wvpk/testgen/fuzzspec.py: the same seeds give the same specs and
signals).

`run_hw_sweep` runs the port's decode_states on `device` (the CUDA
kernels on "cuda", the default; their plain versions on "cpu"), or
sharded over a `mesh` (parallel.sharded_decode_states), against the scalar
oracle, so the exact same randomized coverage as wvpk's sweep runs against
the kernels that ship.
"""

from __future__ import annotations

import numpy as np

from .encoder import EncodeSpec

TERM_POOL = [1, 2, 3, 4, 5, 6, 7, 8, 17, 18]
NEG_TERMS = [-1, -2, -3]


def random_spec(rng: np.random.Generator,
                family: str | None = None) -> EncodeSpec:
    """Random mode-matrix spec. `family` None picks among plain PCM,
    extended int32 (wvx / zeros / ones / dups with random sent_bits and
    max_width) and float; every family randomizes channels/terms/joint."""
    mono = bool(rng.random() < 0.25)
    false_stereo = not mono and bool(rng.random() < 0.15)
    # 25% deep chains (9..16 terms, MAX_NTERMS=Defines.cs:104): exercises
    # the 10/12/16 decorr tier kernels + the term-chain-specialized unroll
    # with randomized differential pressure, not just fixed cases
    if rng.random() < 0.25:
        nterms = int(rng.integers(9, 17))
    else:
        nterms = int(rng.integers(1, 9))
    terms = list(rng.choice(TERM_POOL, size=nterms))
    if not mono and not false_stereo and rng.random() < 0.3:
        terms[0] = int(rng.choice(NEG_TERMS))
    deltas = [int(rng.integers(0, 6)) for _ in terms]
    if family is None:
        family = rng.choice(["plain", "plain", "plain", "int32", "float"])
    base = dict(
        block_samples=int(rng.choice([117, 256, 300, 512, 1000])),
        mono=mono,
        false_stereo=false_stereo,
        joint=bool(rng.random() < 0.6) and not mono and not false_stereo,
        terms=tuple(int(t) for t in terms),
        deltas=tuple(deltas),
        # trailing ID_BLOCK_CHECKSUM item (decode-transparent per the
        # reference; keeps the staging/native-parse paths honest about
        # unknown optional items and feeds the --verify-checksums audit)
        block_checksum=int(rng.choice([0, 0, 0, 0, 2, 4])),
    )
    if family == "int32":
        mode = str(rng.choice(["wvx", "wvx", "zeros", "ones", "dups"]))
        kw = dict(base, bytes_stored=4, int32_mode=mode)
        if mode == "wvx":
            kw["int32_sent_bits"] = int(rng.integers(1, 9))
            # 0 = old-style variable width; else WavPack5 max_width
            kw["int32_max_width"] = int(rng.choice([0, 0, 31, 30,
                                                    int(rng.integers(26, 32))]))
        else:
            kw["int32_" + mode] = int(rng.integers(1, 7))
        return EncodeSpec(**kw)
    if family == "float":
        # max_exp < norm_exp drives the negative-shift arm; 60/161 land
        # beyond +/-32 and exercise the clamp + C# mod-32 no-op quirk
        return EncodeSpec(**base, float_data=True, bytes_stored=4,
                          float_shift=int(rng.choice([0, 0, 0, 3])),
                          float_max_exp=int(rng.choice(
                              [127, 127, 130, 133, 120, 60, 161])),
                          float_norm_exp=127)
    bytes_stored = int(rng.choice([1, 2, 2, 3, 4]))
    hybrid = bool(rng.random() < 0.3)
    hybrid_bitrate = hybrid and bool(rng.random() < 0.4)
    return EncodeSpec(
        **base,
        bytes_stored=bytes_stored,
        shift=int(rng.integers(0, 4)) if not hybrid and bytes_stored > 1
        and rng.random() < 0.3 else 0,
        hybrid=hybrid,
        hybrid_bitrate=hybrid_bitrate,
        bitrate=int(rng.integers(200, 1200)),
        bitrate_delta=int(rng.integers(0, 3)) if hybrid else 0,
        # balance redistribution (WordsUtils.cs:228-243) only acts on true
        # stereo with HYBRID_BITRATE (MONO_DATA takes the mono branch)
        hybrid_balance=hybrid_bitrate and not mono and not false_stereo
        and bool(rng.random() < 0.4),
    )


def random_wvc_spec(rng: np.random.Generator) -> EncodeSpec:
    """Random hybrid-lossless spec (wvc correction pair). Mirrors the
    plain-family randomization with the wvc constraints applied: hybrid
    on, shift off, intra-sample cross terms -1/-2 mapped to -3 (the
    decode-consistent cross prediction; see encode_blocks)."""
    from dataclasses import replace
    spec = random_spec(rng, family="plain")
    hybrid_bitrate = bool(rng.random() < 0.5)
    return replace(
        spec,
        terms=tuple(-3 if t in (-1, -2) else t for t in spec.terms),
        shift=0,
        bytes_stored=int(rng.choice([1, 2, 2, 3])),
        hybrid=True, wvc=True,
        hybrid_bitrate=hybrid_bitrate,
        bitrate=int(rng.integers(200, 1200)),
        bitrate_delta=int(rng.integers(0, 3)),
        hybrid_balance=(hybrid_bitrate and not spec.mono
                        and not spec.false_stereo
                        and bool(rng.random() < 0.4)),
    )


def random_pcm(rng: np.random.Generator, n: int, ch: int,
               spec: EncodeSpec) -> np.ndarray:
    bytes_stored, shift = spec.bytes_stored, spec.shift
    kind = rng.integers(0, 4)
    lim = 1 << (bytes_stored * 8 - 1)
    if spec.float_data:
        # decoded-int domain for the float restore path (24-bit scaled by
        # max_exp - norm_exp); mirror the fixed-case ranges
        lim = 1 << 23
    scale = min(lim // 4, 1 << int(rng.integers(3, 22)))
    if spec.hybrid and bytes_stored <= 3 and rng.random() < 0.25:
        # near-full-scale hybrid: lossy reconstruction overshoots the
        # stored-byte range so the fixup clip (UnpackUtils.cs:1350-1393)
        # fires (kept off bytes_stored=4 / lossless, whose full-scale
        # residuals would enter the excluded median-wrap regime)
        scale = int(lim * 0.7)
    if kind == 0:
        x = rng.normal(0, scale, (n, ch))
    elif kind == 1:
        t = np.arange(n)[:, None]
        x = scale * np.sin(2 * np.pi * t / float(rng.integers(5, 200)))
        x = x + rng.normal(0, scale / 50, (n, ch))
    elif kind == 2:  # sparse/silence heavy
        x = rng.normal(0, scale, (n, ch))
        mask = rng.random((n, 1)) < 0.7
        x = np.where(mask, 0, x)
    else:  # steps / clipping
        x = np.repeat(rng.integers(-scale, scale, ((n + 15) // 16, ch)),
                      16, axis=0)[:n]
    pcm = np.clip(np.round(x), -lim + 1, lim - 1).astype(np.int64)
    if shift:
        pcm = (pcm >> shift) << shift
    # int32 re-expansion families need their bit-structure invariants
    if spec.int32_mode == "zeros":
        pcm = pcm << spec.int32_zeros
    elif spec.int32_mode == "ones":
        pcm = ((pcm + 1) << spec.int32_ones) - 1
    elif spec.int32_mode == "dups":
        d = spec.int32_dups
        pcm = (pcm << d) | np.where(pcm & 1, (1 << d) - 1, 0)
    return pcm


def run_hw_sweep(n_cases: int = 30, n_dsd: int = 8,
                 corrupt: bool = True, verbose: bool = True,
                 seed_base: int = 7000, n_mc: int = 2, n_wvc: int = 4,
                 device="cuda", mesh=None):
    """Differential sweep of decode_states on `device` (or sharded over
    `mesh`) vs the scalar oracle. Returns (fails, blocks).
    `seed_base` selects a disjoint randomized case pool (soak runs use
    fresh bases; PCM seeds are seed_base+i, DSD seeds seed_base+1000+i,
    multichannel seeds seed_base+2000+i, wvc seeds seed_base+3000+i)."""
    from ..container import parse_blocks
    from ..container.blocks import pair_wvc
    from ..engine import decode_states as _decode_states
    from ..parallel import sharded_decode_states
    from ..ref import decode_block

    def decode_states(states):
        if mesh is not None:
            return sharded_decode_states(states, mesh)
        return _decode_states(states, device)

    from . import encode_dsd_file, encode_file
    from .encoder import encode_blocks
    from .multichannel import encode_multichannel

    fails = blocks_checked = 0
    for seed in range(n_cases):
        rng = np.random.default_rng(seed_base + seed)
        spec = random_spec(rng)
        n = int(rng.integers(spec.block_samples // 2,
                             spec.block_samples * 2 + 1))
        pcm = random_pcm(rng, n, spec.nch_data, spec)
        data = encode_file(pcm, spec)
        if corrupt and rng.random() < 0.2:
            data = bytearray(data)
            data[int(rng.integers(64, len(data)))] ^= int(rng.integers(1, 256))
            data = bytes(data)
        blocks = parse_blocks(data)
        dev = decode_states([b.state for b in blocks])
        for blk, d in zip(blocks, dev):
            want = decode_block(blk.state)
            blocks_checked += 1
            if not (np.array_equal(d.samples, want.samples)
                    and d.mute_error == want.mute_error
                    and d.crc_error == want.crc_error):
                fails += 1
                if verbose:
                    print(f"MISMATCH seed {seed}: {spec}")
    for seed in range(n_dsd):
        rng = np.random.default_rng(seed_base + 1000 + seed)
        mode = int(rng.choice([0, 1, 3]))
        mono = bool(rng.random() < 0.3)
        ch = 1 if mono else 2
        d = rng.integers(0, 256, (int(rng.integers(200, 800)), ch))
        data = encode_dsd_file(d.astype(np.int64), mode, mono=mono,
                               # reference caps history_bits at 5
                               # (DsdUtils.cs:167); big-bin tables stress
                               # the mode-1 kernel's bins*256 lookup rows
                               history_bits=int(rng.integers(1, 6)))
        if corrupt and rng.random() < 0.25:
            # corrupt-stream differential: exercises the DSD concealment
            # arms (mode-1 bad-index/err path, CRC -> 0x55 mute fill) on
            # the real kernels; metadata hits drop the block at parse on
            # both sides
            data = bytearray(data)
            data[int(rng.integers(64, len(data)))] ^= int(
                rng.integers(1, 256))
            data = bytes(data)
        blocks = parse_blocks(data)
        dev = decode_states([b.state for b in blocks])
        for blk, dd in zip(blocks, dev):
            want = decode_block(blk.state)
            blocks_checked += 1
            if not (np.array_equal(dd.samples, want.samples)
                    and dd.mute_error == want.mute_error
                    and dd.crc_error == want.crc_error):
                fails += 1
                if verbose:
                    print(f"DSD MISMATCH seed {seed} mode {mode}")
    for seed in range(n_mc):
        # multichannel segments (INITIAL..FINAL stream runs): every stream
        # block is just another lane, asserted block-for-block vs oracle
        rng = np.random.default_rng(seed_base + 2000 + seed)
        spec = random_spec(rng, family="plain")
        nch = int(rng.integers(3, 9))
        n = int(rng.integers(spec.block_samples // 2,
                             spec.block_samples + 1))
        pcm = random_pcm(rng, n, nch, spec)
        data = encode_multichannel(pcm, spec)
        blocks = parse_blocks(data)
        dev = decode_states([b.state for b in blocks])
        for blk, dd in zip(blocks, dev):
            want = decode_block(blk.state)
            blocks_checked += 1
            if not (np.array_equal(dd.samples, want.samples)
                    and dd.crc_error == want.crc_error):
                fails += 1
                if verbose:
                    print(f"MC MISMATCH seed {seed} nch {nch}: {spec}")
    for seed in range(n_wvc):
        # hybrid-lossless pairs: device vs oracle AND exactness vs the
        # source (the wvc guarantee itself), plus a corrupt-wvc case
        rng = np.random.default_rng(seed_base + 3000 + seed)
        spec = random_wvc_spec(rng)
        n = int(rng.integers(spec.block_samples // 2,
                             spec.block_samples * 2 + 1))
        pcm = random_pcm(rng, n, spec.nch_data, spec)
        pcm2 = pcm if pcm.ndim > 1 else pcm[:, None]
        sink: list = []
        data = b"".join(encode_blocks(pcm2, spec, wvc_sink=sink))
        wvc = b"".join(sink)
        if corrupt and rng.random() < 0.25:
            wvc = bytearray(wvc)
            wvc[int(rng.integers(40, len(wvc)))] ^= int(
                rng.integers(1, 256))
            wvc = bytes(wvc)
        blocks = parse_blocks(data)
        pair_wvc(blocks, wvc)
        dev = decode_states([b.state for b in blocks])
        any_err = False
        out = []
        for blk, dd in zip(blocks, dev):
            want = decode_block(blk.state)
            blocks_checked += 1
            any_err |= dd.crc_error
            out.append(dd.samples[:, :pcm2.shape[1]]
                       if not spec.false_stereo else dd.samples[:, :1])
            if not (np.array_equal(dd.samples, want.samples)
                    and dd.crc_error == want.crc_error
                    and dd.crc_wvc == want.crc_wvc):
                fails += 1
                if verbose:
                    print(f"WVC MISMATCH seed {seed}: {spec}")
        if not any_err and not np.array_equal(
                np.concatenate(out), pcm2):
            fails += 1
            if verbose:
                print(f"WVC NOT EXACT seed {seed}: {spec}")
    return fails, blocks_checked
