"""Device selection: every entry point passes its `device=` through here.

"cpu" runs the plain PyTorch versions of the kernels, "cuda" the CUDA
kernels. A request for "cuda" on a machine without a usable GPU raises;
nothing here swaps in another device than the one asked for.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but "
                "torch.cuda.is_available() is False")
    elif dev.type != "cpu":
        raise ValueError(
            f"unsupported device {str(device)!r}: wvpk_torch runs on 'cpu' "
            "(plain PyTorch) or 'cuda' (CUDA kernels)")
    return dev


_side: dict[torch.device, list] = {}


def side_streams(dev: torch.device, n: int) -> list:
    """`n` side streams of the CUDA device `dev`, made at first use and
    kept (the decorrelation runs of a mixed bucket and a call's DSD groups
    run on them)."""
    have = _side.setdefault(dev, [])
    while len(have) < n:
        have.append(torch.cuda.Stream(dev))
    return have[:n]
