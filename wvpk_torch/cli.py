"""CLI: .wv -> .wav decoder and .wav -> .wv encoder on the GPU (port of
wvpk/cli.py).

    python -m wvpk_torch.cli in.wv -o out.wav [--device cuda|cpu]
        [--wvc [PATH] | --no-wvc]
    python -m wvpk_torch.cli a.wv b.wv ... --batch
    python -m wvpk_torch.cli in.wv --report | --verify-checksums
    python -m wvpk_torch.cli --encode in.wav -o out.wv [--device cuda|cpu]
        [--preset fast|default|high] [--hybrid-bitrate N] [--streaming] ...

Single-file mode mirrors the reference demo's output and end checks
(WvDemo.cs:15-168: sample-count equality and crc_errors == 0, exit code 1
on failure). A sibling `<input>c` correction file is picked up
automatically, as wvunpack does: hybrid blocks then decode losslessly;
`--wvc PATH` names another correction file (one input only) and
`--no-wvc` ignores it. Float streams write an IEEE-float WAV. DSD
streams write their byte-values: after a stored DSF header the payload is
re-blocked as DSF, so a .wv wrapping a .dsf decodes back to that file byte
for byte; `--raw` writes the bytes alone. Batch mode
decodes many files' .wv streams in one device batch and reports
throughput. `--report` prints a JSON decode report per file
(report.py), `--verify-checksums` audits every block's stored
ID_BLOCK_CHECKSUM (alone, or before the decode when an output is asked
for). Encode mode runs the device encoder on `--device`, as wvpk's
`--encode --device` does; .dsf inputs and `--wvc` (a hybrid file with its
correction file) take the host encoder, as wvpk's CLI does without
`--device`.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import time

import numpy as np

from . import api, consts, trace
from .io.pcm import format_samples
from .io.wav import make_wav_header, write_wav
from .report import build_report


def decode_one(path: str, out_path: str | None, quiet: bool = False,
               show_trace: bool = False, raw: bool = False,
               streaming: bool | None = None, verify_md5: bool = False,
               device: str = "cuda", wvc: str | None = None,
               no_wvc: bool = False, report_json: bool = False) -> int:
    t_open = time.perf_counter()
    # unlike the reference demo (first two channels only), decode every
    # stream of multichannel files; pair the sibling correction file
    # unless told otherwise
    flags = consts.OPEN_ALL_CHANNELS
    if not no_wvc and wvc is None:
        flags |= consts.OPEN_WVC
    wpc = api.WavpackOpenFileInput(path, flags=flags, streaming=streaming,
                                   wvc_source=None if no_wvc else wvc,
                                   device=device)
    try:
        return _decode_open(wpc, path, out_path, quiet, show_trace, raw,
                            verify_md5, t_open, report_json)
    finally:
        wpc.close()


def _decode_open(wpc, path, out_path, quiet, show_trace, raw, verify_md5,
                 t_open, report_json) -> int:
    err = api.WavpackGetErrorMessage(wpc)
    if err:
        print(f"Error: {err}", file=sys.stderr)
        return 1

    num_channels = api.WavpackGetNumChannels(wpc)
    bits = api.WavpackGetBitsPerSample(wpc)
    byteps = api.WavpackGetBytesPerSample(wpc)
    total_samples = api.WavpackGetNumSamples(wpc, native=True)
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
        if api.WavpackGetMode(wpc) & consts.MODE_WVC:
            print(f"Lossless decoding (hybrid + wvc correction) on "
                  f"{wpc.device}")
        else:
            print(f"{'Lossy' if api.WavpackLossy(wpc) else 'Lossless'} "
                  f"decoding on {wpc.device}")
        level = api.WavpackGetCompressionLevel(wpc)
        if level:
            print(f"{level} compression level")

    is_dsd = bool(api.WavpackGetMode(wpc) & consts.MODE_DSD)
    # float streams format to IEEE float32 on the stream's grid (an
    # extension: the reference demo writes clipped 24-bit ints)
    float_exp = (api.WavpackGetFloatNormExp(wpc)
                 if api.WavpackGetIsFloat(wpc) else 0) or None
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
    dsf_writer = None
    try:
        if out_f is not None and not raw:
            # raw mode is container-less: interleaved little-endian PCM
            # (or the native DSD / float32 bytes) exactly as formatted
            hdr = api.WavpackGetHeader(wpc)
            if hdr:
                out_f.write(hdr)
                if is_dsd and api.WavpackGetFileFormat(wpc) \
                        == consts.FORMAT_DSF:
                    dsf_writer = _dsf_writer(out_f, hdr, num_channels)
            elif float_exp is not None:
                out_f.write(make_wav_header(
                    max(total_samples, 0), num_channels, sample_rate, 32, 4,
                    fmt_tag=3))
            else:
                out_f.write(make_wav_header(
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
                    fmt = api.WavpackFormatSamples(
                        buf, got * num_channels, byteps, dsd=is_dsd,
                        float_norm_exp=float_exp)
                if dsf_writer is not None:
                    dsf_writer.append(
                        buf[:got * num_channels].reshape(got, num_channels))
                elif out_f is not None:
                    out_f.write(fmt)
                if md5er is not None:
                    md5er.update(fmt)
        t1 = time.perf_counter()
        if out_f is not None and not raw:
            if dsf_writer is not None:
                dsf_writer.finish()
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
    if report_json:
        print(build_report(wpc, file=path, decode_seconds=t1 - t0,
                           samples_decoded=total_unpacked,
                           stage_seconds=stages.seconds()).to_json())

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


def _dsf_writer(out_f, hdr: bytes, num_channels: int):
    """A DsfRewriter for a stored DSF header: DSF payloads are
    channel-interleaved fixed-size blocks (LSB-first bits when the header
    says so), so the byte-values are re-blocked as they come. None when
    the header does not parse (the bytes are then written as they are)."""
    from .io.dsf import DsfRewriter, parse_dsf_header

    try:
        _c, _r, dbits, _n, bsz = parse_dsf_header(hdr)
    except ValueError:
        return None
    return DsfRewriter(out_f, num_channels, bsz, lsb_first=dbits == 1)


def decode_batch(paths: list[str], quiet: bool = False,
                 device: str = "cuda") -> int:
    """Decode many files lane-parallel in ONE device batch: every block of
    every file becomes a lane (the batch analog of WvDemo's serial loop)."""
    from .container import parse_blocks
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
                r.samples, (b.header.flags & consts.BYTES_STORED) + 1,
                dsd=bool(b.header.flags & consts.DSD_FLAG),
                float_norm_exp=(b.state.float_norm_exp or None)
                if b.header.flags & consts.FLOAT_DATA else None))
        hdr0 = blocks[0].header
        is_float = bool(hdr0.flags & consts.FLOAT_DATA)
        bps = 4 if is_float else (hdr0.flags & consts.BYTES_STORED) + 1
        n = sum(b.header.block_samples for b in blocks)
        out_path = (path[:-3] if path.endswith(".wv") else path) + ".wav"
        srate_idx = (hdr0.flags & consts.SRATE_MASK) >> consts.SRATE_LSB
        rate = consts.SAMPLE_RATES[srate_idx] if srate_idx < 15 else 44100
        write_wav(out_path, b"".join(chunks), total_samples=n,
                  num_channels=nch, sample_rate=rate,
                  bits_per_sample=bps * 8, bytes_per_sample=bps,
                  fmt_tag=3 if is_float else 1)
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


def encode_dsf_one(path: str, out_path: str, *, mode: int,
                   checksum_bytes: int = 0, quiet: bool = False) -> int:
    """DSF -> .wv DSD encode with the host encoder: stores the DSF
    prefix/trailer + file_format so decode reproduces the file
    byte-exactly."""
    from .encode import encode_dsd
    from .io.dsf import read_dsf

    t0 = time.perf_counter()
    with open(path, "rb") as f:
        blob = f.read()
    try:
        data, rate, header, trailer = read_dsf(blob)
        wv = encode_dsd(data, mode, dsd_rate=rate, header=header,
                        trailer=trailer, file_format=consts.FORMAT_DSF,
                        block_checksum=checksum_bytes)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    with open(out_path, "wb") as f:
        f.write(wv)
    if not quiet:
        dt = time.perf_counter() - t0
        print(f"encoded {data.shape[0]} DSD byte-samples x "
              f"{data.shape[1]} ch (mode {mode}) in {dt * 1000:.1f} ms: "
              f"{len(blob)} -> {len(wv)} bytes "
              f"({len(wv) / max(len(blob), 1):.1%})")
    return 0


def encode_one(path: str, out_path: str, *, preset: str, block: int,
               hybrid_bitrate: int, checksum_bytes: int = 0,
               quiet: bool = False, device: str = "cuda",
               streaming: bool = False, dsd_mode: int = 0,
               float_lossy: bool = False, wvc: bool = False) -> int:
    """WAV -> .wv with the device encoder on `device`; with `wvc` (the
    device encoder writes no correction stream) the host encoder."""
    from .encode import encode, encode_device, encode_wav_file
    from .io.wav import read_wav

    with open(path, "rb") as f:
        if f.read(4) == b"DSD ":
            return encode_dsf_one(path, out_path, mode=dsd_mode,
                                  checksum_bytes=checksum_bytes,
                                  quiet=quiet)
    on = None if wvc else device
    t0 = time.perf_counter()
    try:
        if streaming:
            # bounded-memory two-pass: the WAV payload never fully loads
            info = encode_wav_file(
                path, out_path, device=on, block_samples=block,
                preset=preset, hybrid=hybrid_bitrate > 0,
                bitrate=hybrid_bitrate or 512,
                float_lossy=float_lossy, wvc=wvc,
                block_checksum=checksum_bytes)
            dt = time.perf_counter() - t0
            if not quiet:
                print(f"encoded {info['samples']} samples x "
                      f"{info['channels']} ch in {dt * 1000:.1f} ms "
                      f"({info['windows']} windows) on {on or 'host'}: "
                      f"{os.path.getsize(path)} -> "
                      f"{info['bytes_written']} bytes")
            return 0
        with open(path, "rb") as f:
            blob = f.read()
        pcm, rate, bits, header, trailer = read_wav(blob)
        if float_lossy and pcm.dtype == np.float32 and not quiet:
            from .encode import float_grid_info
            gi = float_grid_info(pcm)
            if not gi["lossless"]:
                print(f"float content is off-grid: quantizing to grid "
                      f"2**{gi['norm_exp'] - 150} (max error "
                      f"{gi['max_error']:.3g})")
        kw = dict(sample_rate=rate, bytes_per_sample=(bits + 7) // 8,
                  block_samples=block, preset=preset,
                  hybrid=hybrid_bitrate > 0, bitrate=hybrid_bitrate or 512,
                  float_lossy=float_lossy, wvc=wvc,
                  block_checksum=checksum_bytes, riff_header=header,
                  riff_trailer=trailer)
        wv = encode(pcm, **kw) if on is None else \
            encode_device(pcm, device=on, **kw)
    except (ValueError, struct.error) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    dt = time.perf_counter() - t0
    wvc_bytes = None
    if isinstance(wv, tuple):
        wv, wvc_bytes = wv
    with open(out_path, "wb") as f:
        f.write(wv)
    if wvc_bytes is not None:
        with open(out_path + "c", "wb") as f:   # wvunpack's convention
            f.write(wvc_bytes)
        if not quiet:
            print(f"wrote correction file {out_path}c "
                  f"({len(wvc_bytes)} bytes)")
    if not quiet:
        print(f"encoded {pcm.shape[0]} samples x {pcm.shape[1]} ch "
              f"({bits}-bit) in {dt * 1000:.1f} ms on {on or 'host'}: "
              f"{len(blob)} -> {len(wv)} bytes "
              f"({len(wv) / max(len(blob), 1):.1%})")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="wvpk_torch", description="WavPack decoder on the GPU")
    p.add_argument("inputs", nargs="+",
                   help=".wv input file(s) (.wav or .dsf with --encode)")
    p.add_argument("-o", "--output", help="output .wav path (single input)")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where to decode or encode: cuda (the CUDA "
                        "kernels, default) or cpu (their plain PyTorch "
                        "versions)")
    p.add_argument("--trace", action="store_true",
                   help="print per-stage timing breakdown")
    p.add_argument("--report", action="store_true",
                   help="print a JSON decode report per file")
    p.add_argument("--batch", action="store_true",
                   help="decode all inputs in one lane-parallel device batch")
    p.add_argument("--raw", action="store_true",
                   help="write raw interleaved samples with no WAV "
                        "container")
    p.add_argument("--streaming", action="store_true",
                   help="force bounded-memory streaming decode (lazy "
                        "block parse + segment-cache eviction; automatic "
                        "for large files); with --encode, bounded-memory "
                        "two-pass window-streamed encode")
    p.add_argument("--verify-md5", action="store_true",
                   help="verify decoded audio against the file's stored "
                        "MD5 checksum (fails if the file carries none)")
    p.add_argument("--verify-checksums", action="store_true",
                   help="audit every block's stored ID_BLOCK_CHECKSUM "
                        "(WavPack 5 extension; blocks without one are "
                        "counted but not errors)")
    p.add_argument("--wvc", nargs="?", const=True, default=None,
                   metavar="PATH",
                   help="decode: pair this correction file (one input "
                        "only; without PATH, or by default, the sibling "
                        "<input>c is picked up). encode: with "
                        "--hybrid-bitrate, also write the hybrid-lossless "
                        "correction file <output>c (host encoder)")
    p.add_argument("--no-wvc", action="store_true",
                   help="ignore any correction file (plain lossy hybrid "
                        "decode)")
    p.add_argument("--encode", action="store_true",
                   help="encode mode: inputs are .wav (or .dsf) files, "
                        "output is .wv (lossless unless --hybrid-bitrate)")
    p.add_argument("--preset", choices=("fast", "default", "high"),
                   default="default", help="encode filter preset")
    p.add_argument("--block-samples", type=int, default=4096,
                   help="encode block size in samples")
    p.add_argument("--hybrid-bitrate", type=int, default=0,
                   help="encode hybrid-lossy with this bitrate value "
                        "(WordsUtils.cs bitrate_acc>>16 units); 0 = "
                        "lossless")
    p.add_argument("--checksum-bytes", type=int, choices=(0, 2, 4),
                   default=0,
                   help="stamp ID_BLOCK_CHECKSUM (WavPack 5) of this "
                        "width on every encoded block")
    p.add_argument("--dsd-mode", type=int, choices=(0, 1, 3), default=0,
                   help="DSD encode mode for .dsf inputs: 0 raw, "
                        "1 fast range coder, 3 high arithmetic coder")
    p.add_argument("--float-lossy", action="store_true",
                   help="encode off-grid float32 WAVs by quantizing to "
                        "the nearest FLOAT_DATA grid (stream is stamped "
                        "lossy); without it such content is rejected")
    args = p.parse_args(argv)

    if args.output and len(args.inputs) > 1 and not args.batch:
        print("Error: -o/--output requires a single input file",
              file=sys.stderr)
        return 2
    if args.encode:
        rc = 0
        for path in args.inputs:
            out = args.output if args.output \
                else (path[:-4] if path.endswith((".wav", ".dsf"))
                      else path) + ".wv"
            rc |= encode_one(path, out, preset=args.preset,
                             block=args.block_samples,
                             hybrid_bitrate=args.hybrid_bitrate,
                             checksum_bytes=args.checksum_bytes,
                             quiet=args.quiet, device=args.device,
                             streaming=args.streaming,
                             dsd_mode=args.dsd_mode,
                             float_lossy=args.float_lossy,
                             wvc=bool(args.wvc))
        return rc
    wvc_path = args.wvc if isinstance(args.wvc, str) else None
    if wvc_path is not None and (len(args.inputs) > 1 or args.batch):
        print("Error: --wvc PATH pairs one correction file with a single "
              "input file (siblings are picked up without it)",
              file=sys.stderr)
        return 2
    if args.verify_checksums:
        from .container import verify_file_checksums
        rc = 0
        for path in args.inputs:
            ok, bad, absent = verify_file_checksums(path)
            if not args.quiet or bad:
                print(f"{path}: {ok} block checksums ok, {bad} bad, "
                      f"{absent} absent",
                      file=sys.stderr if bad else sys.stdout)
            if bad:
                rc = 1
        # audit-only unless the user also asked for decode output
        if rc or not (args.output or args.batch):
            return rc
    if args.batch:
        return decode_batch(args.inputs, args.quiet, args.device)
    rc = 0
    for path in args.inputs:
        out = args.output or (
            (path[:-3] if path.endswith(".wv") else path) + ".wav")
        rc |= decode_one(path, out, args.quiet, show_trace=args.trace,
                         raw=args.raw,
                         streaming=True if args.streaming else None,
                         verify_md5=args.verify_md5, device=args.device,
                         wvc=wvc_path, no_wvc=args.no_wvc,
                         report_json=args.report)
    return rc


if __name__ == "__main__":
    sys.exit(main())
