"""Device encode: block assembly around the encode kernels (port of
wvpk/engine/device_encoder.py).

`encode_blocks_device(pcm, spec, device=...)` produces standard WavPack
block byte strings like `testgen.encoder.encode_blocks`, with the hot
loops lane-parallel on `device` and blocks as lanes: for lossless the
decorrelation inversion (`ops/encode_select.invert_any`) and the word
coder (`words_any`), for hybrid the fused reconstruction-feedback scan
(`hybrid_scan_any`). On "cuda" the kernels of csrc/ run, on "cpu" their
plain versions; both give the same bytes, which are wvpk's device
encoder's. Each block is seeded independently (zero state, or the warm
state adapted over its own first `warmup` samples), so blocks are
independent lanes. The kernels write each lane's payload, final flush
included, and the block CRCs reduce on the device, so one small fetch
(bit totals and CRC accumulators) and one payload fetch come back.

The stages, each a `trace` span under the `encode` root: `stage_lanes`
(enc_prep: joint transform and lane staging; enc_warm: the warm scan,
with enc_warm.fetch its state's copy to the host, which waits for the
scan; enc_meta: per-block metadata and seeds, quantized exactly as the
metadata stores them), `scan_lanes` (enc_scan: enqueue), then enc_fetch
(the first synchronising copy, which waits for the scans), enc_pack
(each lane's payload bytes) and enc_assemble (headers, metadata, CRCs).
Container assembly reuses the host encoder's helpers so the two encoders
cannot drift.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import consts, trace
from ..ops.encode_pack import finish_crc, hybrid_crc_acc, payload_bytes
from ..ops.encode_select import hybrid_scan_any, invert_any, words_any
from ..parallel.mesh import make_mesh, sharded_encode_scans, \
    sharded_hybrid_encode_scan, sharded_invert_warm_state
from ..testgen.encoder import (EncodeSpec, EncPass, _auto_medians,
                               _make_words_state, _quantize_decorr,
                               _quantize_entropy, _quantize_hybrid,
                               _stored_domain, mkmeta)


def _crc_x_fast(vals: np.ndarray, crc0: int = 0xFFFFFFFF) -> int:
    """Closed-form extended CRC: the affine recurrence
    crc_x = crc_x*9 + lo16*3 + hi16 (UnpackUtils.cs:1308) over the
    decoder's post-injection values, evaluated as
    9^M*crc0 + sum 9^(M-1-j)*g_j mod 2^32 (numpy uint32 wraps like C#)."""
    x = vals.astype(np.int64).astype(np.uint32)
    m = x.size
    if m == 0:
        return crc0
    g = ((x & 0xFFFF) * np.uint32(3) + (x >> np.uint32(16)))
    p = np.full(m, 9, np.uint32)
    p[0] = 1
    p = np.multiply.accumulate(p)            # 9^j mod 2^32
    acc = int(np.add.reduce(p[::-1] * g, dtype=np.uint32))
    return (acc + pow(9, m, 1 << 32) * crc0) & 0xFFFFFFFF


def _wvx_meta_fast(spec: EncodeSpec, full_pcm: np.ndarray) -> bytes:
    """Vectorized old-style wvx sidecar for one block: sent_bits low
    bits per value, LSB-first in (time, channel) order, plus the
    closed-form crc_mvx stamp (reference read side
    UnpackUtils.cs:1271-1314; the host encoder's scalar analog is
    testgen/encoder.py::_build_wvx).

    FALSE_STEREO blocks need care: the decoder runs fixup over
    2*block_samples entries with the upper half zeros
    (UnpackUtils.cs:1265), so entries past the written payload read the
    BitWriter zero padding and then the 0xff EOF fill — deterministic
    junk whose crc_x contribution must be reproduced exactly for the
    crc_mvx stamp to verify."""
    assert spec.int32_max_width == 0, "device encoder emits old-style wvx"
    sent = spec.int32_sent_bits
    mask = (1 << sent) - 1
    vals = full_pcm.reshape(-1).astype(np.int64)   # (time, ch) interleave
    lows = (vals & mask).astype(np.uint16)
    bits = ((lows[:, None] >> np.arange(sent, dtype=np.uint16)) & 1)
    payload = np.packbits(bits.reshape(-1).astype(np.uint8),
                          bitorder="little").tobytes()
    if len(payload) & 1:
        payload += b"\x00"
    if spec.false_stereo:
        n = full_pcm.shape[0]
        stream = np.concatenate([
            np.unpackbits(np.frombuffer(payload, np.uint8),
                          bitorder="little"),
            np.ones(2 * n * sent, np.uint8)])[:2 * n * sent]
        data = (stream.reshape(2 * n, sent).astype(np.int64)
                << np.arange(sent, dtype=np.int64)).sum(axis=1)
        # upper-half entries are zeros; injected value == junk data
        dec_vals = np.concatenate([vals, data[n:]])
    else:
        dec_vals = vals
    crc_x = _crc_x_fast(dec_vals)
    return mkmeta(consts.ID_WVX_BITSTREAM,
                  crc_x.to_bytes(4, "little") + payload)


def _zero_underived_slots(p) -> None:
    """Zero the ring slots the decoder does NOT derive from metadata.
    They are write-before-read in the scan (ring terms read slot k at
    sample k, which is written at sample k-term for k >= term), so this
    only normalizes state — outputs are unchanged."""
    t = p.term
    keep = 2 if t > consts.MAX_TERM else (1 if t < 0 else t)
    for k in range(keep, consts.MAX_TERM):
        p.sa[k] = 0
        p.sb[k] = 0


def _prep_targets(spec: EncodeSpec, stored, starts, L, T, C, mono):
    """Joint transform + lane staging arrays (vectorized; encoder.py
    semantics). Returns (targ (L, T, C) int64, nsamp, targ_d (T, L, C)
    int32, terms16, deltas16, nt)."""
    bs = spec.block_samples
    targ = np.zeros((L, T, C), np.int64)
    nsamp = np.zeros(L, np.int32)
    for i, s0 in enumerate(starts):
        blk = stored[s0:s0 + bs].astype(np.int64)
        nsamp[i] = blk.shape[0]
        if not mono and (spec.flags() & consts.JOINT_STEREO):
            sd = (blk[:, 0] - blk[:, 1]).astype(np.int32).astype(np.int64)
            blk = np.stack([sd, (blk[:, 1] + (sd >> 1)).astype(np.int32)], 1)
        targ[i, :blk.shape[0]] = blk

    terms16 = np.zeros((L, 16), np.int32)
    deltas16 = np.zeros((L, 16), np.int32)
    nt = np.full(L, len(spec.terms), np.int32)
    terms16[:, :len(spec.terms)] = spec.terms
    deltas16[:, :len(spec.terms)] = spec.deltas
    targ_d = np.ascontiguousarray(targ.transpose(1, 0, 2).astype(np.int32))
    return targ, nsamp, targ_d, terms16, deltas16, nt


@dataclass
class Lanes:
    """A batch of blocks staged as lanes: the kernels' inputs on the
    device (`t`: targets (T, L, C) int32, the (L, 16) chains, seeds,
    entropy and hybrid state, valid word counts) and what assembly
    needs on the host."""
    spec: EncodeSpec
    pcm: np.ndarray
    stored: np.ndarray
    starts: list
    nsamp: np.ndarray
    mono: bool
    hybrid: bool
    metas: list
    t: dict
    devices: list     # the scans' mesh (parallel.make_mesh), t's device first

    @property
    def kw(self) -> dict:
        kw = dict(mono=self.mono)
        if self.hybrid:
            kw.update(hybrid_bitrate=bool(self.spec.hybrid_bitrate),
                      hybrid_balance=bool(self.spec.hybrid_balance))
        return kw


def warm_state(targ, terms, deltas, num_terms, *, mono: bool,
               static_terms: tuple):
    """The decorrelation inversion over `targ` (K, L, C) from zero seeds:
    only its final state (wa, wb, ha, hb) per lane."""
    L, dev = targ.shape[1], targ.device
    z16 = torch.zeros((L, 16), dtype=torch.int64, device=dev)
    z168 = torch.zeros((L, 16, 8), dtype=torch.int64, device=dev)
    _, state = invert_any(targ, terms, deltas, num_terms, z16, z16, z168,
                          z168, mono=mono, static_terms=static_terms,
                          with_state=True)
    return state


def lossless_scans(targ, terms, deltas, num_terms, med0, nvals, w0a, w0b,
                   h0a, h0b, *, mono: bool, static_terms: tuple):
    """The lossless encode scans: the decorrelation inversion from the
    seeds (w0a, w0b, h0a, h0b), then the word coder. Returns words_any's
    (payload words (L, cap) int32, total bits (L,) int64)."""
    res = invert_any(targ, terms, deltas, num_terms, w0a, w0b, h0a, h0b,
                     mono=mono, static_terms=static_terms)
    T, L, C = res.shape
    return words_any(res.permute(0, 2, 1).reshape(T * C, L), med0, nvals,
                     mono=mono)


def stage_lanes(pcm: np.ndarray, spec: EncodeSpec, warmup: int,
                device, pad_to: int | None = None,
                mesh: list | None = None) -> Lanes:
    """Joint transform, the warm scan and the per-block metadata: a
    `Lanes` on `device`, ready for `scan_lanes`. The scans shard their
    lanes over `mesh` (parallel.make_mesh, `device` its first entry; by
    default [device], the unsharded scans)."""
    mesh = mesh or [device]
    hybrid = bool(spec.hybrid)
    mono = spec.nch_data == 1
    stored = _stored_domain(pcm, spec)
    if stored.size and int(np.abs(stored).max()) >= (1 << 27):
        raise ValueError("device encoder: stored magnitude >= 2^27")
    n = pcm.shape[0]
    bs = spec.block_samples
    starts = list(range(0, n, bs))
    L = len(starts)
    C = 1 if mono else 2
    T = min(bs, max(n, pad_to or 0))

    with trace.stage("enc_prep"):
        targ, nsamp, targ_d, terms16, deltas16, nt = _prep_targets(
            spec, stored, starts, L, T, C, mono)
        t = {k: torch.from_numpy(v).to(device) for k, v in (
            ("targets", targ_d), ("terms", terms16), ("deltas", deltas16),
            ("num_terms", nt))}
    # per-block seeds: fresh (zeros) or WARM — adapt the decorr state
    # over the block's own first `warmup` samples on device, quantize it
    # exactly like the metadata stores it, and seed the main scan with
    # the decoder-derived values (a lookahead-adaptation strategy that
    # recovers most of the fresh-seed compression cost while keeping
    # blocks independent lanes)
    with trace.stage("enc_warm"):
        warm = warmup > 0 and len(spec.terms) > 0
        if warm:
            K = min(warmup, T)
            state = sharded_invert_warm_state(
                t["targets"][:K], t["terms"], t["deltas"], t["num_terms"],
                mesh, mono=mono, static_terms=tuple(spec.terms))
            rot = (np.arange(8) + (K & 7)) & 7          # _rotate_ring order
            with trace.stage("enc_warm.fetch"):
                wfa, wfb, hfa, hfb = (s.cpu().numpy() for s in state)
            hfa, hfb = hfa[:, :, rot], hfb[:, :, rot]
    with trace.stage("enc_meta"):
        med0 = np.zeros((L, 2, 3), np.int64)
        slow0 = np.zeros((L, 2), np.int64)
        acc0 = np.zeros((L, 2), np.int64)
        delta0 = np.zeros((L, 2), np.int64)
        w0a = np.zeros((L, 16), np.int64)
        w0b = np.zeros((L, 16), np.int64)
        h0a = np.zeros((L, 16, 8), np.int64)
        h0b = np.zeros((L, 16, 8), np.int64)
        metas = []
        for i, s0 in enumerate(starts):
            passes = [EncPass(t_, d)
                      for t_, d in zip(spec.terms, spec.deltas)]
            if warm:
                for j, p in enumerate(passes):
                    p.wa, p.wb = int(wfa[i, j]), int(wfb[i, j])
                    p.sa = [int(x) for x in hfa[i, j]]
                    p.sb = [int(x) for x in hfb[i, j]]
            w = _make_words_state(spec, _auto_medians(
                _stored_domain(pcm[s0:s0 + bs], spec)))
            tmd, wmd, smd = _quantize_decorr(passes, mono)
            emd = _quantize_entropy(w, mono)      # quantizes w's medians too
            hmd = None
            if hybrid:
                # quantizes w's slow_level/bitrate state too (encoder.py:504)
                hmd = mkmeta(consts.ID_HYBRID_PROFILE,
                             _quantize_hybrid(spec, w, mono))
                if spec.version == 0x402:
                    # v4.02 hybrid prepends 2 bytes/channel that readers
                    # skip (UnpackUtils.cs:277-283)
                    smd = b"\x00\x00" * (1 if mono else 2) + smd
                slow0[i] = (w.c[0].slow_level, w.c[1].slow_level)
                acc0[i] = w.bitrate_acc
                delta0[i] = w.bitrate_delta
            if warm:
                for j, p in enumerate(passes):
                    _zero_underived_slots(p)
                    w0a[i, j], w0b[i, j] = p.wa, p.wb
                    h0a[i, j] = p.sa
                    h0b[i, j] = p.sb
            med0[i, 0] = w.c[0].median
            med0[i, 1] = w.c[1].median
            metas.append((tmd, wmd, smd, emd, hmd))
        t.update({k: torch.from_numpy(v).to(device) for k, v in (
            ("w0a", w0a), ("w0b", w0b), ("h0a", h0a), ("h0b", h0b),
            ("med0", med0), ("slow0", slow0), ("acc0", acc0),
            ("delta0", delta0), ("nvals", nsamp * C))})
    return Lanes(spec, pcm, stored, starts, nsamp, mono, hybrid, metas, t,
                 mesh)


def scan_lanes(lanes: Lanes):
    """The encode kernels over the staged lanes: (payload words (L, cap)
    int32, total bits (L,) int64, CRC accumulators (L,) int64), on the
    lanes' device: the scans run sharded over the lanes' devices
    (parallel/mesh.py) and their outputs gather on the first. The block
    CRC covers the decoded values: the targets for lossless blocks, the
    scan's reconstruction for hybrid ones."""
    t, kw = lanes.t, lanes.kw
    seeds = (t["w0a"], t["w0b"], t["h0a"], t["h0b"])
    chain = (t["targets"], t["terms"], t["deltas"], t["num_terms"])
    # every lane carries the spec's chain: its compiled kernels run
    static = tuple(lanes.spec.terms)
    if lanes.hybrid:
        words, total, decoded = sharded_hybrid_encode_scan(
            *chain, t["med0"], t["slow0"], t["acc0"], t["delta0"],
            t["nvals"], *seeds, lanes.devices, static_terms=static, **kw)
    else:
        words, total = sharded_encode_scans(
            *chain, t["med0"], t["nvals"], lanes.devices,
            static_terms=static, seeds=seeds, **kw)
        decoded = t["targets"]
    crc_acc = hybrid_crc_acc(
        decoded, t["nvals"], mono=lanes.mono,
        joint=bool(lanes.spec.flags() & consts.JOINT_STEREO))
    return words, total, crc_acc


@trace.stage("encode")
def encode_blocks_device(pcm: np.ndarray, spec: EncodeSpec,
                         warmup: int = 0, *, device="cuda",
                         mesh: list | None = None,
                         start_sample: int = 0, first: bool = True,
                         last: bool = True,
                         md5_digest: bytes | None = None,
                         pad_to: int | None = None) -> list[bytes]:
    """Encode PCM into WavPack blocks with the encode kernels on
    `device` ("cuda": the CUDA kernels; "cpu": their plain versions).

    Lossless: the decorrelation inversion, then the word coder. Hybrid
    (lossy): one fused scan — the lossy reconstruction feeds back into
    the decorr state, so the stages cannot split. Hybrid blocks never
    start zero-run escapes (each run gate emits gamma(0) and codes the
    word; always a valid stream, ~2 bits/word above the host encoder in
    digital silence).

    Wide-32-bit content (int32_mode == "wvx") emits the sent-bits
    low-bit sidecar per block (ID_WVX_BITSTREAM + crc_mvx,
    UnpackUtils.cs:1271-1314), packed vectorized on the host; the
    device scans code the stored high bits.

    Restrictions (use the host encoders otherwise): hybrid excludes
    float/int32 content; stored magnitudes < 2^27 (keeps medians in the
    non-wrapping regime the kernels contract on).

    `mesh` (parallel.make_mesh) shards the warm scan and the encode scans
    over its devices, lanes staged on its first device (`device` is then
    not read); the blocks are the unsharded call's, byte for byte.

    Batch positioning (the streaming encoder's hooks; blocks are
    independent lanes, so a file can be emitted in any lane batching):
    `start_sample` offsets the headers' block_index; `first`/`last`
    gate the file-level metadata (RIFF header / MD5 + trailer);
    `md5_digest` supplies a precomputed whole-file digest when `pcm` is
    only this batch's window (spec.total_samples_override must then
    carry the file total). `pad_to` (the file total) pins the lane
    padding T to what a whole-file batch would use: the warm seeding
    scan adapts over min(warmup, T) steps INCLUDING a short last
    block's zero padding, so a window must pad like the batch for its
    bytes to stay split-invariant.
    """
    hybrid = bool(spec.hybrid)
    if hybrid and (spec.float_data or spec.int32_mode is not None):
        raise ValueError("device encoder: hybrid is plain-PCM only")
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    assert pcm.shape[1] == spec.nch_data
    mesh = make_mesh(devices=[device] if mesh is None else mesh)
    lanes = stage_lanes(pcm, spec, warmup, mesh[0], pad_to, mesh)

    with trace.stage("enc_scan"):
        words, total, crc_acc = scan_lanes(lanes)
    with trace.stage("enc_fetch"):
        small = torch.stack([total, crc_acc]).cpu().numpy()
    total, crc_acc = small[0], small[1]
    if total.size and int(total.max()) > 32 * words.shape[1]:
        # the kernels and the plain packer drop words past the capacity
        raise RuntimeError(
            f"device encoder: a block's payload ({int(total.max())} bits) "
            f"overflows its capacity ({32 * words.shape[1]} bits)")
    with trace.stage("enc_pack"):
        payloads = payload_bytes(words, total)
    with trace.stage("enc_assemble"):
        return _assemble(lanes, payloads, crc_acc,
                         start_sample=start_sample, first=first, last=last,
                         md5_digest=md5_digest)


def _assemble(lanes: Lanes, payloads, crc_acc, *, start_sample, first,
              last, md5_digest) -> list[bytes]:
    """Container assembly (mirrors encoder.py::encode_block)."""
    from ..container.header import HEADER_SIZE

    spec, pcm, starts, nsamp = lanes.spec, lanes.pcm, lanes.starts, \
        lanes.nsamp
    C = 1 if lanes.mono else 2
    L = len(starts)
    total = spec.total_samples_override
    if total is None:
        total = pcm.shape[0]
    # MAG from the PRE-joint stored values: the decoder's mute limit
    # (2^mag + 2, UnpackUtils.cs:517; hybrid doubles it) checks the
    # joint-UNDONE values
    maxabs = np.maximum.reduceat(np.abs(lanes.stored).max(axis=1), starts)
    out = []
    for i, s0 in enumerate(starts):
        tmd, wmd, smd, emd, hmd = lanes.metas[i]
        nb = int(nsamp[i])
        flags = (spec.flags() | consts.INITIAL_BLOCK | consts.FINAL_BLOCK
                 | (min(int(maxabs[i]).bit_length(), 30) << consts.MAG_LSB))
        mdl = [mkmeta(consts.ID_DECORR_TERMS, tmd),
               mkmeta(consts.ID_DECORR_WEIGHTS, wmd),
               mkmeta(consts.ID_DECORR_SAMPLES, smd),
               mkmeta(consts.ID_ENTROPY_VARS, emd)]
        if hmd is not None:
            mdl.append(hmd)
        if spec.float_data:
            mdl.append(mkmeta(consts.ID_FLOAT_INFO,
                              bytes([spec.float_flags, spec.float_shift,
                                     spec.float_max_exp,
                                     spec.float_norm_exp])))
        if spec.int32_mode is not None:
            mdl.append(mkmeta(consts.ID_INT32_INFO,
                              bytes([spec.int32_sent_bits, spec.int32_zeros,
                                     spec.int32_ones, spec.int32_dups])))
        if spec.sample_rate not in consts.SAMPLE_RATES:
            mdl.append(mkmeta(consts.ID_SAMPLE_RATE,
                              (spec.sample_rate & 0xFFFFFF)
                              .to_bytes(3, "little")))
        if i == 0 and first and spec.config_flags:
            cf = spec.config_flags
            mdl.append(mkmeta(consts.ID_CONFIG_BLOCK,
                              bytes([(cf >> 8) & 0xFF, (cf >> 16) & 0xFF,
                                     (cf >> 24) & 0xFF])))
        if i == 0 and first and spec.riff_header is not None:
            mdl.append(mkmeta(consts.ID_RIFF_HEADER, spec.riff_header))
        mdl.append(mkmeta(consts.ID_WV_BITSTREAM, payloads[i]))
        if spec.int32_mode == "wvx" and spec.int32_sent_bits:
            mdl.append(_wvx_meta_fast(spec, pcm[s0:s0 + nb]))
        if i == L - 1 and last and spec.md5:
            digest = md5_digest
            if digest is None:
                import hashlib

                from ..io.pcm import format_samples
                outp = (pcm if not spec.false_stereo
                        else np.repeat(pcm, 2, 1))
                digest = hashlib.md5(
                    format_samples(outp, spec.bytes_stored)).digest()
            mdl.append(mkmeta(consts.ID_MD5_CHECKSUM, digest))
        if i == L - 1 and last and spec.riff_trailer is not None:
            mdl.append(mkmeta(consts.ID_RIFF_TRAILER, spec.riff_trailer))
        body = b"".join(mdl)
        header = bytearray(HEADER_SIZE)
        header[0:4] = b"wvpk"
        header[4:8] = (HEADER_SIZE + len(body) - 8).to_bytes(4, "little")
        header[8:10] = spec.version.to_bytes(2, "little")
        bidx = s0 + start_sample
        header[10] = (bidx >> 32) & 0xFF
        header[11] = (total >> 32) & 0xFF
        header[12:16] = (total & 0xFFFFFFFF).to_bytes(4, "little")
        header[16:20] = (bidx & 0xFFFFFFFF).to_bytes(4, "little")
        header[20:24] = nb.to_bytes(4, "little")
        header[24:28] = flags.to_bytes(4, "little")
        header[28:32] = finish_crc(int(crc_acc[i]), nb * C).to_bytes(
            4, "little")
        block = bytes(header) + body
        if spec.block_checksum:
            from ..container.checksum import add_block_checksum
            block = add_block_checksum(block, spec.block_checksum)
        out.append(block)
    return out


def encode_multichannel_device(pcm: np.ndarray, spec: EncodeSpec,
                               channel_mask: int | None = None,
                               warmup: int = 0, *, device="cuda",
                               mesh: list | None = None,
                               start_sample: int = 0, first: bool = True,
                               last: bool = True,
                               md5_digest: bytes | None = None,
                               pad_to: int | None = None) -> bytes:
    """Device encode of a >2ch segment (INITIAL..FINAL stream runs with
    ID_CHANNEL_INFO, like testgen.multichannel.encode_multichannel).
    Each stream's blocks are one lane batch on `device`; streams are
    encoded independently (self-seeded) and their blocks interleaved per
    time window. The keyword hooks position `pcm` as one window of a
    larger stream (see encode_blocks_device); device blocks are
    independent lanes, so any window split is byte-identical to the
    batch. `mesh` shards each stream's lanes (encode_blocks_device)."""
    from ..testgen.multichannel import (_inject_metadata,
                                        _set_segment_flags, split_streams,
                                        stream_specs)

    n, nch = pcm.shape
    assert nch > 2
    widths = split_streams(nch)
    if channel_mask is None:
        channel_mask = (1 << nch) - 1

    stream_blocks = []
    off = 0
    for si, (w, sspec) in enumerate(zip(widths, stream_specs(spec, nch))):
        # file-level metadata rides specific segment slots: the RIFF
        # header on the first stream's first block, the trailer on the
        # last stream's last block, the MD5 injected below
        sspec = replace(
            sspec, md5=False,
            riff_header=spec.riff_header if si == 0 else None,
            riff_trailer=spec.riff_trailer if si == len(widths) - 1
            else None)
        stream_blocks.append(encode_blocks_device(
            pcm[:, off:off + w], sspec, warmup, device=device, mesh=mesh,
            start_sample=start_sample, first=first, last=last,
            pad_to=pad_to))
        off += w

    chan_info = bytes([nch]) + channel_mask.to_bytes(
        max(1, (channel_mask.bit_length() + 7) // 8), "little")
    digest = md5_digest
    if spec.md5 and last and digest is None:
        import hashlib

        from ..io.pcm import format_samples
        digest = hashlib.md5(format_samples(
            pcm, spec.bytes_stored)).digest()

    out = bytearray()
    nwin = len(stream_blocks[0])
    for win in range(nwin):
        for si in range(len(widths)):
            blk = stream_blocks[si][win]
            blk = _set_segment_flags(blk, initial=(si == 0),
                                     final=(si == len(widths) - 1))
            if first and win == 0 and si == 0:
                blk = _inject_metadata(
                    blk, mkmeta(consts.ID_CHANNEL_INFO, chan_info))
            if spec.md5 and digest is not None and last \
                    and win == nwin - 1 and si == len(widths) - 1:
                blk = _inject_metadata(
                    blk, mkmeta(consts.ID_MD5_CHECKSUM, digest))
            if spec.block_checksum:
                from ..container.checksum import add_block_checksum
                blk = add_block_checksum(blk, spec.block_checksum)
            out += blk
    return bytes(out)
