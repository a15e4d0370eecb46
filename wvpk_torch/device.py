"""Device selection: every entry point passes its `device=` through here.

"cpu" runs the plain PyTorch versions of the kernels, "cuda" the CUDA
kernels. A request for "cuda" on a machine without a usable GPU raises;
nothing here swaps in another device than the one asked for. The streams
the pipeline forks work onto are kept here too: side streams (a mixed
bucket's decorrelation runs, a call's DSD groups, a mesh's shards on one
card, `run_side_by_side`) and a copy stream a card (chunked delivery).
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


_side: dict[tuple, list] = {}


def side_streams(dev: torch.device, n: int) -> list:
    """`n` side streams of the CUDA device `dev` to fork work onto from its
    current stream, made at first use and kept. Each stream forked from
    has a pool of its own, so a fork nested in a side stream's work (a
    mixed bucket's decorrelation runs inside a mesh shard) never queues
    behind its parent's siblings."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    have = _side.setdefault(key, [])
    while len(have) < n:
        have.append(torch.cuda.Stream(dev))
    return have[:n]


def tensors_in(x):
    """Every tensor in `x`: a tensor, or a dict, list or tuple holding
    tensors (other values are skipped)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from tensors_in(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from tensors_in(v)


def run_side_by_side(jobs: list) -> list:
    """`fn(inputs)` for each (device, inputs, fn) of `jobs`, the outputs in
    job order. A CUDA device with two jobs or more runs each on a side
    stream of it, all forked from the device's current stream before the
    first launch (after whatever staging copies were queued there) and
    joined back into it after the last, so that they run side by side;
    each job's inputs are recorded on its side stream and its outputs on
    the current stream, so the caching allocator hands none back early.
    A device's only job, and every CPU job, runs in order on the current
    stream."""
    count: dict[torch.device, int] = {}
    for dev, _inputs, _fn in jobs:
        if dev.type == "cuda":
            count[dev] = count.get(dev, 0) + 1
    streams = {dev: side_streams(dev, n) for dev, n in count.items()
               if n > 1}
    for dev, side in streams.items():
        main = torch.cuda.current_stream(dev)
        for stream in side:
            stream.wait_stream(main)
    nth = dict.fromkeys(streams, 0)
    outs = []
    for dev, inputs, fn in jobs:
        if dev not in streams:
            outs.append(fn(inputs))
            continue
        stream = streams[dev][nth[dev]]
        nth[dev] += 1
        with torch.cuda.stream(stream):
            res = fn(inputs)
        main = torch.cuda.current_stream(dev)
        for t in tensors_in(inputs):
            if t.is_cuda:
                t.record_stream(stream)
        for t in tensors_in(res):
            if t.is_cuda:
                t.record_stream(main)
        outs.append(res)
    for dev, side in streams.items():
        main = torch.cuda.current_stream(dev)
        for stream in side:
            main.wait_stream(stream)
    return outs


_copy: dict[torch.device, object] = {}


def copy_stream(dev: torch.device):
    """The CUDA device's stream for overlapped device-to-host copies, made
    at first use and kept."""
    if dev not in _copy:
        _copy[dev] = torch.cuda.Stream(dev)
    return _copy[dev]
