"""Encode-side packing and the hybrid CRC (port of wvpk/ops/encode_pack.py).

`pack_segments_words` concatenates each lane's bit slots (see
ops/encode_kernels.py) into its LSB-first payload in tensor ops: an
exclusive cumsum of the slot lengths gives every slot's bit offset, each
slot (< 2^34) shifted by its offset within a 32-bit word covers at most
three consecutive words, and one index_add per word slot accumulates
them. Every payload bit comes from exactly one slot, so the adds never
carry. `pack_segments_device` appends the pending word's final flush as
one more step and packs, which is the plain version of what the CUDA
encode kernels write directly; `payload_bytes` fetches the words and cuts
each lane's bytes. wvpk's host packer (engine/device_encoder.py::
pack_segments) is the byte oracle.

`hybrid_crc_acc` reduces the hybrid block CRC's data-sized part on the
device (the CRC is the affine recurrence crc = 3 crc + x over the decoded
values, UnpackUtils.cs:577,626) and `finish_crc` completes it on the host.
PyTorch has no uint32 multiply, so products are taken mod 2^32 from 16-bit
halves in int64, which never overflows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .bitio import wrap32
from .encode_kernels import _flush

I64 = torch.int64
M32 = 0xFFFFFFFF
# most bits one word adds to a stream: a run gamma (<= 29), or a unary
# escape (17 + 34 + 32) and a payload (<= 33), plus the hybrid run gate's
# bit; and the final flush (<= 116)
MAX_WORD_BITS = 120
TAIL_BITS = 160


def payload_cap(nwords: int) -> int:
    """32-bit payload words a lane of `nwords` coded words can need: the
    capacity the encode kernels write into (and the plain packers pad
    to)."""
    return (nwords * MAX_WORD_BITS + TAIL_BITS + 31) // 32


def pack_segments_words(bits, lens, *, nw_cap: int):
    """Pack (W, L, S) bit slots into (L, nw_cap) int32 payload words (word
    w holds stream bits [32w, 32w + 32), LSB first; zero past the end).
    Returns (words, total_bits (L,) int64). Bits past nw_cap words are
    dropped, as the CUDA kernels drop them: a total over nw_cap * 32 is
    the caller's error to raise."""
    W, L, S = lens.shape
    dev = lens.device
    ln = lens.to(I64).permute(1, 0, 2).reshape(L, W * S)
    end = torch.cumsum(ln, dim=1)
    total = end[:, -1] if W * S else torch.zeros(L, dtype=I64, device=dev)
    off = end - ln
    row = nw_cap + 3          # room for a slot's overhang past the cap
    out = torch.zeros(L * row, dtype=I64, device=dev)
    lane_base = torch.arange(L, device=dev)[:, None] * row
    flat = bits.permute(1, 0, 2).reshape(L, W * S)
    for k in range(S):        # one slot column at a time bounds the memory
        m = (ln[:, k::S] > 0) & ((off[:, k::S] >> 5) < nw_cap)
        if not bool(m.any()):
            continue
        o = off[:, k::S][m]
        b = flat[:, k::S][m]
        s = o & 31
        t0 = (b & M32) << s
        t1 = (b >> 32) << s
        w0 = (lane_base.expand(L, W)[m]) + (o >> 5)
        for j, v in enumerate((t0 & M32, (t0 >> 32) | (t1 & M32), t1 >> 32)):
            out.index_add_(0, w0 + j, v)
    words = wrap32(out.view(L, row)[:, :nw_cap]).to(torch.int32)
    return words, total


def segment_total_bits(lens):
    """Per-lane payload bit totals (L,) int64 of (W, L, S) slot lengths."""
    return lens.to(I64).sum(dim=(0, 2))


def pack_segments_device(bits, lens, pvalid, poc, pbits, pnb):
    """A scan's slots and pending word -> (words (L, payload_cap(W))
    int32, total_bits (L,) int64): the payload including the final flush
    of the pending word (EntropyEncoder.finish), as the CUDA encode
    kernels write it."""
    W = lens.shape[0]
    tail = _flush(pvalid, 2 * poc.to(I64), pbits.to(I64), pnb.to(I64))
    tail.append((torch.zeros_like(tail[0][0]),) * 2)
    tb = torch.stack([b for b, _ in tail], dim=1)[None]
    tl = torch.stack([n for _, n in tail], dim=1)[None].to(lens.dtype)
    return pack_segments_words(torch.cat([bits, tb]), torch.cat([lens, tl]),
                               nw_cap=payload_cap(W))


def payload_bytes(words, total) -> list[bytes]:
    """Each lane's payload bytes from the (L, cap) words and bit totals:
    one fetch of the words the longest lane needs."""
    total = np.asarray(total.cpu() if isinstance(total, torch.Tensor)
                       else total, np.int64)
    nw = int(total.max() + 31) // 32 if total.size else 0
    wnp = np.ascontiguousarray(words[:, :nw].cpu().numpy())
    return [wnp[i].tobytes()[:(int(total[i]) + 7) // 8]
            for i in range(len(total))]


CRC_INV3 = pow(3, -1, 1 << 32)   # 3 is odd => invertible mod 2^32


def _mulmod32(a, b):
    """a * b mod 2^32 for int64 tensors a, b in [0, 2^32)."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & M32


@functools.lru_cache(maxsize=8)
def _inv3_powers(n: int, device: torch.device) -> torch.Tensor:
    """3^(-j) mod 2^32 for j < n, as int64."""
    q = np.full(n, CRC_INV3, np.uint64)
    q[0] = 1
    q = np.multiply.accumulate(q) & np.uint64(M32)
    return torch.from_numpy(q.astype(np.int64)).to(device)


def hybrid_crc_acc(recon, nvals, *, joint: bool, mono: bool):
    """Device half of the hybrid block CRC: acc = sum_j 3^(-j) x_j mod
    2^32 over each lane's first nvals decoded values (joint stereo undone,
    interleaved (time, ch)), so that crc = 3^M crc0 + 3^(M-1) acc
    (`finish_crc`) equals testgen.encoder._crc_fast. recon (T, L, C);
    returns (L,) int64 in [0, 2^32)."""
    T, L, C = recon.shape
    v = recon.to(I64)
    if joint and not mono:
        r = wrap32(v[:, :, 1] - (v[:, :, 0] >> 1))
        v = torch.stack([wrap32(r + v[:, :, 0]), r], dim=2)
    vals = v.permute(0, 2, 1).reshape(T * C, L) & M32
    q = _inv3_powers(T * C, recon.device)[:, None]
    mask = torch.arange(T * C, device=recon.device)[:, None] \
        < nvals.to(I64)[None, :]
    terms = torch.where(mask, _mulmod32(vals, q), 0)
    return terms.sum(dim=0) & M32


def finish_crc(acc: int, m: int, crc0: int = 0xFFFFFFFF) -> int:
    """Host half: crc = 3^m crc0 + 3^(m-1) acc mod 2^32 (m = value count;
    m == 0 degenerates to crc0)."""
    if m == 0:
        return crc0
    return (pow(3, m, 1 << 32) * crc0
            + pow(3, m - 1, 1 << 32) * int(acc)) & 0xFFFFFFFF
