"""Device-encode dispatch by tensor device (port of
wvpk/ops/encode_select.py).

CPU tensors take the plain PyTorch versions (encode_kernels.py packed by
encode_pack.py), CUDA tensors the kernels (encode_cuda.py). There is no
option and no fallback between them. `invert_any` and `hybrid_scan_any`
take wvpk's `static_terms` ("every lane carries this chain"): on the card
each runs its kernel compiled for that chain where
ops/decorr_cuda.py::ENCODE_CHAINS has one, else the run-time kernel, which
reads each lane's chain, so every chain runs on the card (mono chains with
cross terms too, which wvpk leaves to its XLA scan); the plain versions
ignore it. The word coder has no chain.
"""

from __future__ import annotations

from .encode_cuda import decorr_invert_cuda, encode_words_cuda, \
    encode_words_plain, hybrid_encode_cuda, hybrid_encode_plain
from .encode_kernels import decorr_invert_warm


def _on_cuda(t) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no encoder for device {t.device}")
    return False


def invert_any(targets, terms, deltas, num_terms, w0a, w0b, h0a, h0b, *,
               mono: bool, static_terms: tuple | None = None,
               with_state: bool = False):
    """Decorrelation inversion (targets -> residuals), with the final
    state on request; the contract of encode_kernels.decorr_invert_warm.
    `static_terms`: the chain every lane carries, if the caller knows
    one."""
    fn = decorr_invert_cuda if _on_cuda(targets) else decorr_invert_warm
    return fn(targets, terms, deltas, num_terms, w0a, w0b, h0a, h0b,
              mono=mono, with_state=with_state, static_terms=static_terms)


def words_any(res_words, med0, nvals, *, mono: bool):
    """Lossless word coding: (payload words (L, cap) int32, total bits (L,)
    int64), the final flush included."""
    fn = encode_words_cuda if _on_cuda(res_words) else encode_words_plain
    return fn(res_words, med0, nvals, mono=mono)


def hybrid_scan_any(targets, terms, deltas, num_terms, med0, slow0, acc0,
                    delta0, nvals, w0a, w0b, h0a, h0b, *, mono: bool,
                    hybrid_bitrate: bool, hybrid_balance: bool,
                    static_terms: tuple | None = None):
    """Fused hybrid encode: (payload words, total bits, recon (T, L, C)).
    `static_terms`: the chain every lane carries, if the caller knows
    one."""
    fn = hybrid_encode_cuda if _on_cuda(targets) else hybrid_encode_plain
    return fn(targets, terms, deltas, num_terms, med0, slow0, acc0, delta0,
              nvals, w0a, w0b, h0a, h0b, mono=mono,
              hybrid_bitrate=hybrid_bitrate, hybrid_balance=hybrid_balance,
              static_terms=static_terms)
