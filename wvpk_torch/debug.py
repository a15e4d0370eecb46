"""Debug / sanitizer mode (port of wvpk/debug.py).

The sanitizers that apply to the port:

- `checkify_smoke()`: runs the decorrelation path on tiny inputs with the
  index and range checks that wvpk gets from jax.experimental.checkify
  made explicit: every term a lane runs names a valid history slot, the
  chain length and the array shapes are in range, and so are the outputs;
- `oracle_checked_decode()`: cross-checks every decoded block against the
  scalar oracle, samples and status (the strictest strict-dtype/wraparound
  test);
- `set_options(oracle_check=True)` wires the same check
  (`check_against_oracle`) into every decode.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve


def check_against_oracle(states, results) -> None:
    """Raise AssertionError at the first decoded block whose samples or
    status (mute_error, crc_error) differ from the scalar oracle's."""
    from .ref import decode_block

    for st, res in zip(states, results):
        want = decode_block(st)
        if not np.array_equal(want.samples, res.samples):
            raise AssertionError(
                f"device/oracle mismatch at block {st.header.block_index}")
        if (want.mute_error, want.crc_error) != (res.mute_error, res.crc_error):
            raise AssertionError(
                f"status mismatch at block {st.header.block_index}")


def oracle_checked_decode(states, device="cuda"):
    """Decode on `device` with per-block oracle equality assertion."""
    from .engine import decode_states

    results = decode_states(states, device)
    check_against_oracle(states, results)
    return results


def _check(ok, what: str) -> None:
    if not bool(ok):
        raise AssertionError(f"checkify_smoke: {what}")


def checkify_smoke(device="cuda"):
    """Run the decorrelation path (ops/decorr_select.py) on wvpk's tiny
    checkify inputs with its bounds checks made explicit; returns the
    decorrelated (T, L, 2) int32 samples, as wvpk's checkify_smoke does."""
    from .ops.decorr_select import decorr_post_any

    dev = resolve(device)
    L, T = 4, 32
    residuals = torch.zeros((T, L, 2), dtype=torch.int32, device=dev)
    terms = torch.full((L, 16), 18, dtype=torch.int32, device=dev)
    deltas = torch.full((L, 16), 2, dtype=torch.int32, device=dev)
    w = torch.zeros((L, 16), dtype=torch.int32, device=dev)
    h = torch.zeros((L, 16, 8), dtype=torch.int64, device=dev)
    nt = torch.full((L,), 2, dtype=torch.int32, device=dev)
    nsamples = torch.full((L,), T, dtype=torch.int32, device=dev)
    no = torch.zeros(L, dtype=torch.bool, device=dev)
    mute_limit = torch.full((L,), 1 << 31, dtype=torch.int64, device=dev)

    # index checks: the chain length indexes the 16 passes, each pass's
    # term its history slot (1..8 the ring, 17/18 the two-sample terms,
    # -1..-3 the cross-channel ones), the histories are 8 deep
    _check(((nt >= 0) & (nt <= 16)).all(), "num_terms outside [0, 16]")
    used = torch.arange(16, device=dev)[None, :] < nt[:, None]
    valid = (((terms >= 1) & (terms <= 8)) | (terms == 17) | (terms == 18)
             | ((terms >= -3) & (terms <= -1)))
    _check((valid | ~used).all(), "a term names no history slot")
    _check(((deltas >= 0) & (deltas <= 7) | ~used).all(),
           "a delta outside [0, 7]")
    _check(h.shape == (L, 16, 8) and w.shape == (L, 16),
           "history or weight shape")
    _check(((nsamples >= 0) & (nsamples <= T)).all(),
           "a sample count past the buffer")
    out, _crc, mute = decorr_post_any(
        residuals, terms, deltas, w, w, h, h, nt, nsamples, no, mute_limit,
        no, mono=False)
    # range checks: the outputs are the buffer's shape and int32, and no
    # lane tripped its mute limit
    _check(out.shape == (T, L, 2) and out.dtype == torch.int32,
           f"output {out.dtype} {tuple(out.shape)}")
    _check(not mute.any(), "a lane muted")
    return out.cpu().numpy()
