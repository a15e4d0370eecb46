"""CLI: .wv -> .wav decoder on the GPU (port of wvpk/cli.py, decode side).

    python -m wvpk_torch.cli in.wv -o out.wav [--device cuda|cpu]
    python -m wvpk_torch.cli a.wv b.wv ... --batch

Single-file mode mirrors the reference demo's output and end checks
(WvDemo.cs:15-168: sample-count equality and crc_errors == 0, exit code 1
on failure); batch mode decodes many files in one device batch and reports
throughput. Encoding, correction files and the JSON report stay in
`python -m wvpk.cli`.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from wvpk import consts, trace
from wvpk.io.pcm import format_samples
from wvpk.io.wav import make_wav_header, write_wav

from . import api


def decode_one(path: str, out_path: str | None, quiet: bool = False,
               show_trace: bool = False, raw: bool = False,
               streaming: bool | None = None, verify_md5: bool = False,
               device: str = "cuda") -> int:
    t_open = time.perf_counter()
    # unlike the reference demo (first two channels only), decode every
    # stream of multichannel files
    wpc = api.WavpackOpenFileInput(path, flags=consts.OPEN_ALL_CHANNELS,
                                   streaming=streaming, device=device)
    err = api.WavpackGetErrorMessage(wpc)
    if err:
        print(f"Error: {err}", file=sys.stderr)
        return 1

    num_channels = api.WavpackGetNumChannels(wpc)
    bits = api.WavpackGetBitsPerSample(wpc)
    byteps = api.WavpackGetBytesPerSample(wpc)
    total_samples = api.WavpackGetNumSamples(wpc)
    sample_rate = api.WavpackGetSampleRate(wpc)
    version = api.WavpackGetVersion(wpc)

    if not quiet:
        dur = total_samples / sample_rate if sample_rate else 0
        print(f"The WavPack {'5' if api.WavpackGetIsFive(wpc) else '4'} "
              f"({version >> 8}.{version & 0xFF}) file '{path}' has:")
        print(f"{consts.FORMAT_NAMES[wpc.file_format]} format")
        print(f"{num_channels} channels")
        print(f"{bits} bits per sample")
        print(f"{sample_rate} samples/s")
        print(f"{total_samples} total samples = {dur:.3f}s")
        print(f"{'Lossy' if api.WavpackLossy(wpc) else 'Lossless'} "
              f"decoding on {wpc.device}")
        level = api.WavpackGetCompressionLevel(wpc)
        if level:
            print(f"{level} compression level")

    t0 = time.perf_counter()
    total_unpacked = 0
    # output streams to disk as it is formatted (and the MD5 folds
    # incrementally), so a long decode stays O(buffer) in memory
    md5er = None
    if verify_md5:
        import hashlib
        md5er = hashlib.md5()
    buf = np.zeros(consts.SAMPLE_BUFFER_SIZE * num_channels, np.int32)
    out_f = open(out_path, "wb") if out_path else None
    try:
        if out_f is not None and not raw:
            # raw mode is container-less: interleaved little-endian PCM
            hdr = api.WavpackGetHeader(wpc)
            out_f.write(hdr if hdr else make_wav_header(
                max(total_samples, 0), num_channels, sample_rate, bits,
                byteps))
        with trace.collect() as stages:
            while True:
                got = api.WavpackUnpackSamples(wpc, buf,
                                               consts.SAMPLE_BUFFER_SIZE)
                if got <= 0:
                    break
                total_unpacked += got
                with trace.stage("format"):
                    fmt = api.WavpackFormatSamples(buf, got * num_channels,
                                                   byteps)
                if out_f is not None:
                    out_f.write(fmt)
                if md5er is not None:
                    md5er.update(fmt)
        t1 = time.perf_counter()
        if out_f is not None and not raw:
            trailer = api.WavpackGetTrailer(wpc)
            if trailer:
                out_f.write(trailer)
    finally:
        if out_f is not None:
            out_f.close()

    if not quiet:
        ms = (t1 - t0) * 1000
        rate = total_unpacked / max(t1 - t0, 1e-9) / 1e6
        rt = (total_unpacked / sample_rate) / max(t1 - t0, 1e-9) \
            if sample_rate else 0
        print(f"{ms:.1f} ms to process WavPack file "
              f"({rate:.2f} Msamples/s, {rt:.1f}x realtime; "
              f"open+index {1000 * (t0 - t_open):.1f} ms)")
    if show_trace and not quiet:
        print(trace.format_report(stages, total_unpacked))

    num_samples = api.WavpackGetNumSamples(wpc)
    if num_samples != -1 and total_unpacked != num_samples:
        print("Incorrect number of samples", file=sys.stderr)
        return 1
    crc_count = api.WavpackGetNumErrors(wpc)
    if crc_count > 0:
        print(f"{crc_count} CRC errors detected", file=sys.stderr)
        return 1
    if verify_md5:
        stored = api.WavpackGetMD5Sum(wpc)
        if stored is None:
            print("no MD5 checksum stored in file", file=sys.stderr)
            return 1
        actual = md5er.digest()
        if actual != stored:
            print(f"MD5 mismatch: stored {stored.hex()} != decoded "
                  f"{actual.hex()}", file=sys.stderr)
            return 1
        if not quiet:
            print(f"MD5 verified: {actual.hex()}")
    return 0


def decode_batch(paths: list[str], quiet: bool = False,
                 device: str = "cuda") -> int:
    """Decode many files lane-parallel in ONE device batch: every block of
    every file becomes a lane (the batch analog of WvDemo's serial loop)."""
    from wvpk.container import parse_blocks

    from .engine import decode_states

    t0 = time.perf_counter()
    parsed = []
    all_states = []
    for path in paths:
        with open(path, "rb") as f:
            blocks = parse_blocks(f.read())
        parsed.append((path, blocks))
        all_states += [b.state for b in blocks]
    t1 = time.perf_counter()
    results = decode_states(all_states, device)
    t2 = time.perf_counter()

    rc = 0
    pos = 0
    total_samples = 0
    for path, blocks in parsed:
        chunks = []
        crc_errors = 0
        nch = 1
        for b in blocks:
            r = results[pos]
            pos += 1
            nch = max(nch, r.samples.shape[1])
            crc_errors += int(r.crc_error)
            total_samples += b.header.block_samples
            chunks.append(format_samples(
                r.samples, (b.header.flags & consts.BYTES_STORED) + 1))
        hdr0 = blocks[0].header
        bps = (hdr0.flags & consts.BYTES_STORED) + 1
        n = sum(b.header.block_samples for b in blocks)
        out_path = (path[:-3] if path.endswith(".wv") else path) + ".wav"
        srate_idx = (hdr0.flags & consts.SRATE_MASK) >> consts.SRATE_LSB
        rate = consts.SAMPLE_RATES[srate_idx] if srate_idx < 15 else 44100
        write_wav(out_path, b"".join(chunks), total_samples=n,
                  num_channels=nch, sample_rate=rate,
                  bits_per_sample=bps * 8, bytes_per_sample=bps)
        if crc_errors:
            print(f"{path}: {crc_errors} CRC errors detected",
                  file=sys.stderr)
            rc = 1
    if not quiet:
        dt = t2 - t1
        print(f"batch: {len(paths)} files, {total_samples} samples in "
              f"{dt * 1000:.1f} ms decode on {device} "
              f"({total_samples / max(dt, 1e-9) / 1e6:.2f} Msamples/s; "
              f"parse {1000 * (t1 - t0):.1f} ms)")
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="wvpk_torch", description="WavPack decoder on the GPU")
    p.add_argument("inputs", nargs="+", help=".wv input file(s)")
    p.add_argument("-o", "--output", help="output .wav path (single input)")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where to decode: cuda (the CUDA kernels, default) "
                        "or cpu (their plain PyTorch versions)")
    p.add_argument("--trace", action="store_true",
                   help="print per-stage timing breakdown")
    p.add_argument("--batch", action="store_true",
                   help="decode all inputs in one lane-parallel device batch")
    p.add_argument("--raw", action="store_true",
                   help="write raw interleaved samples with no WAV "
                        "container")
    p.add_argument("--streaming", action="store_true",
                   help="force bounded-memory streaming decode (lazy "
                        "block parse + segment-cache eviction; automatic "
                        "for large files)")
    p.add_argument("--verify-md5", action="store_true",
                   help="verify decoded audio against the file's stored "
                        "MD5 checksum (fails if the file carries none)")
    args = p.parse_args(argv)

    if args.output and len(args.inputs) > 1 and not args.batch:
        print("Error: -o/--output requires a single input file",
              file=sys.stderr)
        return 2
    if args.batch:
        return decode_batch(args.inputs, args.quiet, args.device)
    rc = 0
    for path in args.inputs:
        out = args.output or (
            (path[:-3] if path.endswith(".wv") else path) + ".wav")
        rc |= decode_one(path, out, args.quiet, show_trace=args.trace,
                         raw=args.raw,
                         streaming=True if args.streaming else None,
                         verify_md5=args.verify_md5, device=args.device)
    return rc


if __name__ == "__main__":
    sys.exit(main())
