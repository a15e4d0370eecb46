"""Public PCM -> WavPack encode API (port of wvpk/encode.py).

The host layers are wvpk's, unchanged: `build_spec` and the whole-stream
statistics it derives the spec from, the presets, the float grid
helpers, the host encoders `encode`/`encode_dsd` (the port's copy of
wvpk's test-vector encoder) and the bounded-memory `encode_wav_file`.
`encode_device` and `encode_wav_file(device=...)` run the lane-parallel
device encoder (engine/device_encoder.py) on "cuda" (the CUDA kernels,
the default) or "cpu" (their plain PyTorch versions); both give the same
bytes as wvpk's device encoder. The CLI encode mode is
``python -m wvpk_torch.cli --encode in.wav -o out.wv [--device cuda|cpu]
[--streaming]``.

Every stream it emits decodes on every decoder path: lossless decode is
sample-exact, hybrid obeys the reference's error-limit semantics
(WordsUtils.cs:195-261), and the optional MD5 / block-checksum
extensions are stamped for the audit tooling.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from . import consts, trace
from .testgen.encoder import EncodeSpec, mkmeta
from .testgen.multichannel import encode_multichannel

# Decorrelation filter presets (decode order). These are this encoder's
# own chains -- chosen to cover the kernel tiers (2/4-ish/10 unrolled
# passes) -- not copies of any other encoder's tables. Negative
# (cross-channel) terms are stereo-only and stripped for mono content.
PRESETS = {
    "fast": ((17, 17), (2, 2)),
    "default": ((18, 18, 2, 17, 3), (2, 2, 2, 2, 2)),
    "high": ((18, 18, 18, -2, 2, 3, 5, -1, 17, 4),
             (2, 2, 2, 2, 2, 2, 2, 2, 2, 2)),
}


def _auto_shift(or_acc: int, bytes_per_sample: int) -> tuple[int, int]:
    """Common trailing-zero count of the OR-accumulated bit pattern ->
    (shift, int32_zeros).

    bytes <= 3 store it in the header SHIFT field; 4-byte content uses
    the int32 zeros re-expansion (UnpackUtils.cs:1332-1342) instead, the
    WavPack-native way to shrink wide residuals. (Two's complement:
    v>>s<<s == v iff the low s bits of the bit pattern are zero, so the
    OR over all samples carries the whole answer.)
    """
    if or_acc == 0:
        return 0, 0
    tz = min((or_acc & -or_acc).bit_length() - 1, 8)
    if bytes_per_sample >= 4:
        return 0, tz
    return tz, 0


# ---------------------------------------------------------------------------
# float (FLOAT_DATA) grid derivation
#
# The reference decoder's float restore (FloatUtils.cs:32-56) converts
# stored ints to the 24-bit clipped domain; it never reconstructs IEEE
# bits itself, so lossless float round-trips hinge on the ENCODER
# choosing a representation the int domain captures exactly. wvpk's
# contract: a float32 stream is encodable losslessly iff every value
# lies on one uniform grid f = i * 2**-k with |i| < 2**23 (true for
# float WAVs derived from integer sources and for normalized
# full-scale grids — the common production cases). The stored int is
# i, the grid rides float_norm_exp = 150 - k (norm_exp 127 <=> the
# conventional +/-1.0 full-scale 24-bit grid), and max_exp == norm_exp
# with float_shift = 0 so the decoder's shift is a no-op. The decode
# formatter inverts with f = i * 2**(norm_exp - 150), exact in IEEE
# arithmetic because i fits a float32 significand. Content off any
# such grid (free-form mantissas, NaN/Inf, -0.0) needs the sent-bits
# float extensions the reference itself treats as lossy
# (UnpackUtils.cs:57-64) and is rejected with a clear error.
# ---------------------------------------------------------------------------

def _float_grid_req(f: np.ndarray,
                    lossy: bool = False) -> tuple[int | None, float]:
    """(max over values of the minimal k with f*2**k integral, max|f|).

    Rejects NaN/Inf and -0.0 (no lossless int representation in the
    FLOAT_DATA domain). With lossy=True, -0.0 is tolerated (it
    quantizes to +0.0 like any off-grid value); NaN/Inf still raise —
    the int grid has no value to quantize them to."""
    bits = np.ascontiguousarray(f, np.float32).view(np.uint32).reshape(-1)
    if (bits & 0x7F800000 == 0x7F800000).any():
        raise ValueError("float PCM contains NaN or Inf; FLOAT_DATA "
                         "blocks cannot represent them (even lossily)")
    if not lossy and (bits == 0x80000000).any():
        raise ValueError("float PCM contains -0.0, which decodes as +0.0; "
                         "normalize the sign of zeros before encoding, or "
                         "pass float_lossy=True")
    exp = (bits >> 23) & 0xFF
    man = bits & 0x7FFFFF
    sig = np.where(exp > 0, man | (1 << 23), man).astype(np.int64)
    nz = sig != 0
    if not nz.any():
        return None, 0.0
    sig = sig[nz]
    # trailing zeros of the significand: lowbit is a power of two
    # <= 2**23, so float64 log2 is exact
    tz = np.log2((sig & -sig).astype(np.float64)).astype(np.int64)
    e_eff = np.where(exp > 0, exp, 1).astype(np.int64)[nz]
    k_req = int((150 - e_eff - tz).max())
    return k_req, float(np.abs(f).max())


def float_to_stored(f: np.ndarray, norm_exp: int,
                    lossy: bool = False) -> np.ndarray:
    """float32 (n, ch) -> stored int64 domain on the norm_exp grid
    (i = f * 2**(150 - norm_exp); raises if any value is off-grid or
    outside the 24-bit range the decoder clips to). lossy=True rounds
    off-grid values to the nearest grid point and clips to the 24-bit
    range instead of raising."""
    scaled = f.astype(np.float64) * 2.0 ** (150 - norm_exp)
    i = np.round(scaled).astype(np.int64)
    if lossy:
        np.clip(i, -8388607, 8388607, out=i)
        return i
    if not (i == scaled).all():
        raise ValueError("float PCM is off the norm_exp grid")
    if i.size and int(np.abs(i).max()) > 8388607:
        raise ValueError("float PCM exceeds the 24-bit FLOAT_DATA range")
    return i


def pcm_stats(pcm: np.ndarray, float_lossy: bool = False) -> dict:
    """Whole-stream facts build_spec derives from the audio. Chunk-safe:
    `merge_pcm_stats` folds per-window stats into the same answer, so
    the streaming encoder can derive an identical spec from one bounded
    pre-scan pass. float32 input yields float-grid stats instead of the
    integer fields (see the FLOAT_DATA grid note above); float_lossy
    tolerates -0.0 (quantized to +0.0 by the lossy grid path)."""
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    if pcm.dtype.kind == "f":
        if pcm.dtype != np.float32:
            raise ValueError("float PCM must be float32 (WAV format "
                             "tag 3); float64 has no FLOAT_DATA analog")
        k_req, fmax = _float_grid_req(pcm, lossy=float_lossy)
        return {
            "n": pcm.shape[0],
            "ch": pcm.shape[1],
            "float": True,
            "k_req": k_req,
            "fmax": fmax,
            "equal_ch": pcm.shape[1] == 2
                        and bool(np.array_equal(pcm[:, 0], pcm[:, 1])),
        }
    wide = pcm.astype(np.int64)
    return {
        "n": pcm.shape[0],
        "ch": pcm.shape[1],
        "minv": int(wide.min()) if pcm.size else 0,
        "maxv": int(wide.max()) if pcm.size else 0,
        "maxabs": int(np.abs(wide).max()) if pcm.size else 0,
        "or_acc": int(np.bitwise_or.reduce(wide.view(np.uint64), axis=None))
                  if pcm.size else 0,
        "equal_ch": pcm.shape[1] == 2
                    and bool(np.array_equal(pcm[:, 0], pcm[:, 1])),
    }


def merge_pcm_stats(a: dict | None, b: dict) -> dict:
    if a is None:
        return b
    if a["ch"] != b["ch"]:
        raise ValueError("channel count changed mid-stream")
    if a.get("float", False) != b.get("float", False):
        raise ValueError("PCM dtype changed mid-stream")
    if a.get("float"):
        ks = [k for k in (a["k_req"], b["k_req"]) if k is not None]
        return {
            "n": a["n"] + b["n"],
            "ch": a["ch"],
            "float": True,
            "k_req": max(ks) if ks else None,
            "fmax": max(a["fmax"], b["fmax"]),
            "equal_ch": a["equal_ch"] and b["equal_ch"],
        }
    return {
        "n": a["n"] + b["n"],
        "ch": a["ch"],
        "minv": min(a["minv"], b["minv"]),
        "maxv": max(a["maxv"], b["maxv"]),
        "maxabs": max(a["maxabs"], b["maxabs"]),
        "or_acc": a["or_acc"] | b["or_acc"],
        "equal_ch": a["equal_ch"] and b["equal_ch"],
    }


def build_spec(pcm: np.ndarray, *, stats: dict | None = None,
               **options) -> EncodeSpec:
    """Derive an EncodeSpec for `pcm` ((n,) or (n, ch) ints in the
    signed `bytes_per_sample`-wide domain).

    md5=None stamps the source digest for lossless only: like
    libwavpack, a stored MD5 always covers the SOURCE audio, which a
    hybrid-lossy decode legitimately won't match -- pass md5=True to
    stamp it anyway."""
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    if not np.issubdtype(pcm.dtype, np.integer) \
            and pcm.dtype != np.float32:
        raise ValueError(f"integer or float32 PCM required, got dtype "
                         f"{pcm.dtype}")
    if stats is None:
        stats = pcm_stats(pcm,
                          float_lossy=options.get("float_lossy", False))
    return _spec_from_stats(stats, **options)


def _spec_from_stats(st: dict, *, sample_rate: int = 44100,
                     bytes_per_sample: int = 2, block_samples: int = 4096,
                     preset: str = "default", joint: bool = True,
                     hybrid: bool = False, bitrate: int = 512,
                     wvc: bool = False,
                     md5: bool | None = None, block_checksum: int = 0,
                     float_lossy: bool = False,
                     riff_header: bytes | None = None,
                     riff_trailer: bytes | None = None) -> EncodeSpec:
    n, ch = st["n"], st["ch"]
    if n == 0:
        raise ValueError("empty PCM")
    if block_samples <= 0:
        raise ValueError(f"block_samples must be positive, got {block_samples}")
    is_float = st.get("float", False)
    lossy_float = False
    if is_float:
        if hybrid:
            raise ValueError(
                "hybrid float is inherently lossy (the reference flags "
                "such blocks lossy, UnpackUtils.cs:57-64); wvpk encodes "
                "float losslessly only")
        k = st["k_req"] if st["k_req"] is not None else 23
        fits = (1 <= 150 - k <= 255
                and st["fmax"] * 2.0 ** k <= 8388607)
        if not fits and float_lossy:
            # opt-in lossy: quantize to the FINEST grid whose 24-bit
            # range covers the content (the widest restorable domain the
            # reference's shift+clip restore defines, FloatUtils.cs:
            # 32-56), clamped to the norm_exp byte; the stream is
            # stamped CONFIG_LOSSY_MODE so WavpackGetMode never claims
            # MODE_LOSSLESS for it
            import math
            k = (int(math.floor(math.log2(8388607.0 / st["fmax"])))
                 if st["fmax"] > 0 else 23)
            k = max(-105, min(149, k))
            lossy_float = True
        elif not 1 <= 150 - k <= 255:
            raise ValueError(
                f"float grid exponent 2**-{k} is outside the FLOAT_INFO "
                "norm_exp byte range; content is not losslessly "
                "representable as FLOAT_DATA (pass float_lossy=True to "
                "quantize to the nearest representable grid)")
        elif st["fmax"] * 2.0 ** k > 8388607:
            raise ValueError(
                "float PCM spans more than 24 bits of mantissa on its "
                f"grid (needs |f| <= {8388607 * 2.0 ** -k:g} at grid "
                f"2**-{k}); not losslessly representable as FLOAT_DATA "
                "(the reference treats such content as lossy, "
                "UnpackUtils.cs:57-64; pass float_lossy=True to "
                "quantize to the nearest representable grid)")
        norm_exp = 150 - k
        bytes_per_sample = 4
    else:
        norm_exp = 0
        lim = 1 << (bytes_per_sample * 8 - 1)
        if st["minv"] < -lim or st["maxv"] >= lim:
            raise ValueError(f"PCM exceeds the {bytes_per_sample}-byte range")
    if wvc and not hybrid:
        raise ValueError("wvc=True (hybrid-lossless correction file) "
                         "requires hybrid=True")
    terms, deltas = PRESETS[preset]
    if wvc and any(t in (-1, -2) for t in terms):
        # decode applies wvc corrections after the decorr chain; the
        # intra-sample cross terms -1/-2 would need the other channel's
        # CURRENT quantized value inside the peel (see encode_blocks'
        # chain check). -3 predicts from the previous opposite-channel
        # sample — same cross-channel idea, decode-consistent peel.
        terms = tuple(-3 if t in (-1, -2) else t for t in terms)
    mono = ch == 1
    # false stereo: identical channels collapse to one encoded channel
    # (the decoder re-duplicates, UnpackUtils.cs:668-680)
    false_stereo = st["equal_ch"]
    if mono or false_stereo:
        # cross-channel terms are stereo-only (multichannel mono tail
        # streams are stripped inside encode_multichannel instead, so
        # the segment's stereo pairs keep them)
        kept = [(t, d) for t, d in zip(terms, deltas) if t > 0]
        terms, deltas = tuple(t for t, _ in kept), tuple(d for _, d in kept)
    shift, zeros = ((0, 0) if hybrid or is_float
                    else _auto_shift(st["or_acc"], bytes_per_sample))
    # wide 32-bit content: the stored-domain magnitude must stay in the
    # entropy coder's comfortable range (24-bit-audio scale; the log2
    # tables and median adaptation degrade beyond ~2^28, per the
    # reference's own "limited resolution" note). Route the low bits
    # through the wvx raw-bit sidecar (UnpackUtils.cs:1271-1314), the
    # WavPack-native lossless mechanism for that, when trailing zeros
    # alone don't get us there.
    int32_mode = "zeros" if zeros else None
    sent_bits = 0
    if not is_float:
        maxabs = st["maxabs"]
        excess = maxabs.bit_length() - 23 - zeros
        if bytes_per_sample >= 4 and excess > 0:
            if hybrid:
                raise ValueError(
                    "hybrid encoding supports up to ~24-bit magnitudes; "
                    f"content needs {maxabs.bit_length()} bits")
            int32_mode, zeros, sent_bits = "wvx", 0, maxabs.bit_length() - 23
    return EncodeSpec(
        float_data=is_float,
        float_shift=0,
        float_max_exp=norm_exp,
        float_norm_exp=norm_exp,
        block_samples=block_samples,
        mono=mono,
        false_stereo=false_stereo,
        joint=joint and not mono and not false_stereo,
        terms=terms,
        deltas=deltas,
        bytes_stored=bytes_per_sample,
        shift=shift,
        int32_mode=int32_mode,
        int32_zeros=zeros,
        int32_sent_bits=sent_bits,
        sample_rate=sample_rate,
        hybrid=hybrid,
        hybrid_bitrate=hybrid,
        bitrate=bitrate,
        wvc=wvc,
        # like the hybrid default: a stored MD5 covers the SOURCE audio,
        # which a lossy decode legitimately won't match — but a wvc
        # pair restores the source exactly, so it gets the digest
        md5=((not hybrid or wvc) and not lossy_float)
        if md5 is None else md5,
        config_flags=consts.CONFIG_LOSSY_MODE if lossy_float else 0,
        float_lossy=lossy_float,
        block_checksum=block_checksum,
        riff_header=riff_header,
        riff_trailer=riff_trailer,
    )


@trace.stage("encode")
def encode_device(pcm: np.ndarray, *, device="cuda", warmup: int = 512,
                  mesh: list | None = None, **options) -> bytes:
    """Encode integer or float32 PCM to a WavPack stream on `device`
    ("cuda": the CUDA kernels; "cpu": their plain PyTorch versions).

    The two hot loops (decorrelation inversion, entropy word coding) run
    lane-parallel over the file's blocks (`ops/encode_select.py`); every
    block is seeded on its own so blocks are independent lanes. Output
    decodes bit-exactly on all decoder paths; single-block files are
    byte-identical to the host `encode`.

    hybrid=True runs the fused lossy scan (peel -> error-limit coding ->
    reconstruction-feedback apply); hybrid blocks never start zero-run
    escapes (~2 bits/word above the host encoder in digital silence).
    Wide-32-bit content emits the wvx sent-bits sidecar per block
    (host-packed, device-coded high bits). >2ch emits a multichannel
    segment with each stream's blocks as one lane batch.

    warmup (default 512, 0 disables): adapt each block's decorr state
    over its own first `warmup` samples on the device, then seed the
    block with the quantized warm state — recovers the fresh-seed
    compression cost while keeping blocks independent lanes.

    mesh (parallel.make_mesh) shards the encode scans lane-parallel over
    its devices (`device` is then not read): the same bytes as unsharded.
    """
    from .engine.device_encoder import (encode_blocks_device,
                                        encode_multichannel_device)
    if options.get("wvc"):
        raise ValueError(
            "wvc (hybrid-lossless correction files) is host-encode only "
            "for now — the device hybrid scan does not emit the "
            "correction stream; use encode(..., wvc=True)")
    pcm = np.asarray(pcm)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    spec = build_spec(pcm, **options)
    digest = None
    if spec.float_data:
        pcm, digest = _float_stored_and_digest(pcm, spec)
    if pcm.shape[1] > 2:
        return encode_multichannel_device(
            pcm, replace(spec, mono=False, false_stereo=False),
            warmup=warmup, device=device, mesh=mesh, md5_digest=digest)
    if spec.false_stereo:
        pcm = pcm[:, :1]
    return b"".join(encode_blocks_device(pcm, spec, warmup, device=device,
                                         mesh=mesh, md5_digest=digest))


def encode_wav_file(in_path, out_path, *, device="cuda",
                    warmup: int = 512, window_samples: int = 1 << 20,
                    mesh: list | None = None, **options) -> dict:
    """Bounded-memory WAV file -> .wv file encode (two streaming passes).

    Pass 1 scans the payload once to fold `pcm_stats` windows (the spec
    -- shift/wvx routing/false-stereo -- needs whole-stream facts) and
    the whole-file MD5; pass 2 encodes window-by-window, appending
    blocks to `out_path` as they are produced. Peak memory is
    O(window_samples), not O(file): a multi-GB WAV encodes in constant
    space, the encode mirror of the decoder's bounded streaming mode.

    Windows are block-aligned. `device="cuda"` (the default) or `"cpu"`
    runs the lane-parallel device encoder there, whose blocks are
    independent (fresh- or warmup-seeded) lanes, so its output is
    byte-identical to `encode_device` for ANY window split. An explicit
    `device=None` runs the host encoder instead (the only one that
    writes a `.wvc`): its windows thread the carried adaptive state
    across the boundary (one-window files are byte-identical to
    `encode`). >2ch input emits multichannel segments (per-stream carried
    state on host; independent lanes on device). `mesh` (device encoder
    only) shards each window's encode scans over its devices. Returns
    {"samples", "channels", "bytes_written", "windows"}.
    """
    import hashlib

    from .io.pcm import format_samples
    from .io.wav import decode_pcm_bytes, scan_wav_file

    (ch, rate, bits, off, size, header, trailer,
     fmt_tag) = scan_wav_file(in_path)
    is_float = fmt_tag == 3
    bps = (bits + 7) // 8
    options.setdefault("bytes_per_sample", bps)
    options.setdefault("sample_rate", rate)
    options["riff_header"] = header
    options["riff_trailer"] = trailer
    frame = bps * ch
    total = size // frame
    if total == 0:
        raise ValueError("empty PCM")
    bs = options.get("block_samples", 4096)
    win = max(bs, window_samples // bs * bs)

    hybrid = options.get("hybrid", False)
    md5_opt = options.get("md5")
    # wvc restores the source exactly, so it keeps the default digest
    want_md5 = ((not hybrid or options.get("wvc", False))
                if md5_opt is None else md5_opt)
    hasher = hashlib.md5() if want_md5 else None
    st = None
    with open(in_path, "rb") as f:
        f.seek(off)
        done = 0
        while done < total:
            m = min(total - done, win)
            v = decode_pcm_bytes(f.read(m * frame), bps,
                                 float_data=is_float).reshape(-1, ch)
            st = merge_pcm_stats(st, pcm_stats(
                v, float_lossy=options.get("float_lossy", False)))
            if hasher is not None:
                # the stored MD5 covers the formatted output bytes
                # (false-stereo duplication == the original channels;
                # for float that image IS the source float32 bytes)
                hasher.update(
                    v.astype("<f4").tobytes() if is_float
                    else format_samples(v, options["bytes_per_sample"]))
            done += m
    spec = replace(_spec_from_stats(st, **options),
                   total_samples_override=total)
    if ch > 2:
        # segment encoder stamps checksums itself; strip false_stereo
        spec = replace(spec, mono=False, false_stereo=False)
    if spec.float_lossy and md5_opt is None:
        # content turned out lossy on its grid: the default-MD5 source
        # digest would never verify against the decode, drop it (the
        # same default hybrid gets)
        hasher = None
    digest = hasher.digest() if hasher is not None else None

    use_wvc = bool(spec.wvc and spec.hybrid)
    if use_wvc and device is not None:
        raise ValueError(
            "wvc (hybrid-lossless correction files) is host-encode only "
            "for now — drop device or wvc=True")
    if mesh is not None and device is None:
        raise ValueError("mesh shards the device encoder; device=None "
                         "takes the host encoder")

    if device is not None:
        from .engine.device_encoder import (encode_blocks_device,
                                            encode_multichannel_device)
    else:
        from .testgen.encoder import encode_blocks
        from .testgen.multichannel import encode_multichannel
    nbytes = nwvc = nwin = 0
    carry = carries = None
    wvc_out = open(out_path + "c", "wb") if use_wvc else None
    try:
        with open(in_path, "rb") as f, open(out_path, "wb") as out:
            f.seek(off)
            done = 0
            while done < total:
                m = min(total - done, win)
                v = decode_pcm_bytes(f.read(m * frame), bps,
                                     float_data=is_float).reshape(-1, ch)
                if is_float:
                    v = float_to_stored(v, spec.float_norm_exp,
                                        lossy=spec.float_lossy)
                if spec.false_stereo:
                    v = v[:, :1]
                first, last = done == 0, done + m >= total
                sink = [] if use_wvc else None
                if ch > 2 and device is not None:
                    blocks = [encode_multichannel_device(
                        v, spec, warmup=warmup, device=device, mesh=mesh,
                        start_sample=done, first=first, last=last,
                        md5_digest=digest, pad_to=total)]
                elif ch > 2:
                    seg, carries = encode_multichannel(
                        v, spec, start_sample=done, first=first,
                        last=last, md5_digest=digest, carries=carries,
                        return_carries=True, wvc_sink=sink)
                    blocks = [seg]
                elif device is not None:
                    blocks = encode_blocks_device(
                        v, spec, warmup, device=device, mesh=mesh,
                        start_sample=done, first=first, last=last,
                        md5_digest=digest, pad_to=total)
                else:
                    blocks, carry = encode_blocks(
                        v, spec, start_sample=done, first=first,
                        last=last, md5_digest=digest, carry=carry,
                        return_carry=True, wvc_sink=sink)
                for b in blocks:
                    out.write(b)
                    nbytes += len(b)
                if sink:
                    for cb in sink:
                        wvc_out.write(cb)
                        nwvc += len(cb)
                nwin += 1
                done += m
    finally:
        if wvc_out is not None:
            wvc_out.close()
    info = {"samples": total, "channels": ch, "bytes_written": nbytes,
            "windows": nwin}
    if use_wvc:
        info["wvc_bytes_written"] = nwvc
    return info


def float_md5_digest(f: np.ndarray) -> bytes:
    """MD5 of a float stream's decode-side byte image (little-endian
    float32, all channels) — what the float formatter emits and
    --verify-md5 hashes."""
    import hashlib
    return hashlib.md5(
        np.ascontiguousarray(f.astype("<f4")).tobytes()).digest()


def _float_stored_and_digest(pcm: np.ndarray, spec: EncodeSpec):
    """float32 (n, ch) -> (stored int domain, md5 digest or None). A
    stamped MD5 covers the SOURCE audio (the hybrid convention), which
    for a lossy-float encode the decode output won't match."""
    digest = float_md5_digest(pcm) if spec.md5 else None
    return float_to_stored(pcm, spec.float_norm_exp,
                           lossy=spec.float_lossy), digest


def float_grid_info(pcm: np.ndarray) -> dict:
    """Grid diagnostics for float32 content: the lossless FLOAT_DATA
    grid when one exists, else the grid encode(float_lossy=True) would
    quantize to. Returns {"norm_exp", "lossless", "grid_step",
    "max_error"} (max_error = largest |quantized - source|, 0.0 when
    lossless)."""
    pcm = np.asarray(pcm)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    st = pcm_stats(pcm, float_lossy=True)
    spec = _spec_from_stats(st, float_lossy=True)
    stored = float_to_stored(pcm, spec.float_norm_exp,
                             lossy=spec.float_lossy)
    step = 2.0 ** (spec.float_norm_exp - 150)
    err = 0.0
    if spec.float_lossy:
        err = float(np.abs(stored.astype(np.float64) * step
                           - pcm.astype(np.float64)).max())
    return {"norm_exp": spec.float_norm_exp,
            "lossless": not spec.float_lossy,
            "grid_step": step,
            "max_error": err}


def encode_dsd(data: np.ndarray, mode: int = 0, *,
               dsd_rate: int = 2822400, block_samples: int | None = None,
               md5: bool = True, history_bits: int = 1,
               header: bytes | None = None, trailer: bytes | None = None,
               file_format: int | None = None,
               block_checksum: int = 0) -> bytes:
    """Encode raw DSD byte-samples to a WavPack stream.

    data: (n,) mono or (n, ch<=2) uint8 byte-samples (8 DSD bits each,
    MSB-first — WavPack's native DSD domain; io/dsf.py converts DSF's
    LSB-first bytes). mode 0 stores raw bytes + CRC (DsdUtils.cs:73-82),
    mode 1 the "fast" range coder over history-bin probability tables
    (:244-304), mode 3 the "high" adaptive arithmetic coder (:391-493).
    dsd_rate is the 1-bit sampling frequency (2822400 = DSD64); it must
    factor as base * 2**m * 8 with base in the header rate table.
    md5 stamps ID_MD5_CHECKSUM over the native byte image (what
    --verify-md5 hashes). header/trailer store an original container
    prefix/suffix verbatim (ID_ALT_HEADER / ID_ALT_TRAILER) and
    file_format (consts.FORMAT_DSF etc.) rides ID_NEW_CONFIG_BLOCK, so
    the CLI can reproduce the source file byte-exactly. Decode of any
    mode is bit-exact (mode 0/1/3 roundtrip identity is asserted in
    tests)."""
    from .testgen.dsd_encoder import encode_dsd_file
    from .testgen.multichannel import _inject_metadata

    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    if data.dtype != np.uint8:
        if not np.issubdtype(data.dtype, np.integer):
            raise ValueError("DSD data must be uint8 byte-samples")
        if data.size and (int(data.min()) < 0 or int(data.max()) > 255):
            raise ValueError("DSD byte-samples must be in 0..255")
        data = data.astype(np.uint8)
    n, ch = data.shape
    if n == 0:
        raise ValueError("empty DSD data")
    if ch > 2:
        raise ValueError("DSD encode supports mono/stereo")
    if mode not in (0, 1, 3):
        raise ValueError(f"DSD mode must be 0, 1 or 3, got {mode}")
    # dsd_rate = base * multiplier * 8 bits/byte, multiplier = 1<<m
    # (WavpackGetSampleRate(native) inverts this, api.py)
    choice = None
    for base in sorted(set(consts.SAMPLE_RATES), reverse=True):
        q, r = divmod(dsd_rate, base * 8)
        if r == 0 and q > 0 and (q & (q - 1)) == 0:
            choice = (base, q.bit_length() - 1)
            break
    if choice is None:
        raise ValueError(f"dsd_rate {dsd_rate} does not factor as "
                         "base * 2**m * 8 with a standard base rate")
    base_rate, mult_log = choice
    if block_samples is None:
        block_samples = min(n, 1 << 16)

    wv = encode_dsd_file(data.astype(np.int64), mode,
                         mono=ch == 1, mult_log=mult_log,
                         sample_rate=base_rate, history_bits=history_bits,
                         block_samples=block_samples,
                         block_checksum=0)
    # split the stream back into blocks for metadata injection
    blobs = []
    pos = 0
    while pos < len(wv):
        ck = int.from_bytes(wv[pos + 4:pos + 8], "little") + 8
        blobs.append(wv[pos:pos + ck])
        pos += ck
    first_md = []
    if file_format is not None:
        first_md.append(mkmeta(consts.ID_NEW_CONFIG_BLOCK,
                               bytes([file_format])))
    if header is not None:
        first_md.append(mkmeta(consts.ID_ALT_HEADER, header))
    last_md = []
    if md5:
        import hashlib
        last_md.append(mkmeta(
            consts.ID_MD5_CHECKSUM,
            hashlib.md5(np.ascontiguousarray(data).tobytes()).digest()))
    if trailer is not None:
        last_md.append(mkmeta(consts.ID_ALT_TRAILER, trailer))
    out = []
    for i, blk in enumerate(blobs):
        if i == 0:
            for md in reversed(first_md):
                blk = _inject_metadata(blk, md)
        if i == len(blobs) - 1:
            for md in last_md:
                blk = _append_metadata(blk, md)
        if block_checksum:
            from .container.checksum import add_block_checksum
            blk = add_block_checksum(blk, block_checksum)
        out.append(blk)
    return b"".join(out)


def _append_metadata(block: bytes, meta: bytes) -> bytes:
    """Append a metadata sub-block at the end of a block, growing ckSize
    (the tail mirror of testgen.multichannel._inject_metadata)."""
    blk = bytearray(block)
    ck = int.from_bytes(blk[4:8], "little") + len(meta)
    blk[4:8] = ck.to_bytes(4, "little")
    return bytes(blk) + meta


def encode(pcm: np.ndarray, **options) -> bytes:
    """Encode integer or float32 PCM to a WavPack stream.

    pcm: (n,) mono or (n, ch) interleaved ints, signed, within the
    `bytes_per_sample` range — or float32 on a lossless FLOAT_DATA
    grid (see the float grid note above; off-grid content raises).
    ch > 2 emits a multichannel segment (INITIAL/FINAL stream runs +
    ID_CHANNEL_INFO) decodable with OPEN_ALL_CHANNELS. Keyword
    options: see build_spec. Returns the `.wv` byte stream.
    """
    from .testgen.encoder import encode_blocks
    pcm = np.asarray(pcm)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    spec = build_spec(pcm, **options)
    digest = None
    if spec.float_data:
        pcm, digest = _float_stored_and_digest(pcm, spec)
    # hybrid-lossless: collect the parallel correction blocks and return
    # (wv_bytes, wvc_bytes) — the caller writes the second beside the
    # first as the `.wvc` file (beyond reference parity; the reference
    # notes "Correction files are not handled", WavPackUtils.cs:31)
    sink: list | None = [] if spec.wvc else None
    if pcm.shape[1] > 2:
        # segment encoder stamps checksums itself; strip false_stereo
        wv = encode_multichannel(pcm, replace(spec, mono=False,
                                              false_stereo=False),
                                 md5_digest=digest, wvc_sink=sink)
    else:
        if spec.false_stereo:
            pcm = pcm[:, :1]
        wv = b"".join(encode_blocks(pcm, spec, md5_digest=digest,
                                    wvc_sink=sink))
    if sink is not None:
        return wv, b"".join(sink)
    return wv
