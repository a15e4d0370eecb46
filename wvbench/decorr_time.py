"""What the decorrelation metrics read: the decorrelation kernels' device
time in a traced window, and the PCM bytes the window delivered."""

from __future__ import annotations

from wvbench.tracing import _is_kernel

# the kernels of csrc/decorr.cu, by a part of their names
DECORR = "decorr_"
# the share of the read time by which the kernels left out of the trace's
# busiest may at most add to it (see decorr_seconds)
UNLISTED_SHARE = 0.02


def decorr_seconds(run) -> float | None:
    """Summed device time of the operations among the trace's busiest
    (`run.trace["device_ops"]`) whose names hold DECORR; None for an
    encode run, without a trace, or where none is listed. The list holds
    only the busiest names (tracing.reduce), so a decorrelation kernel may
    lie below it: the kernels it leaves out take `kernel_s` less the
    listed kernels' time, and where that is more than UNLISTED_SHARE of
    the time read, the sum could read low by as much, and this is None."""
    trace = run.trace if run.op == "decode" else None
    ops = (trace or {}).get("device_ops")
    times = [s for name, s in ops or () if DECORR in name]
    if not times:
        return None
    listed = sum(s for name, s in ops if _is_kernel(name))
    if trace["kernel_s"] - listed > UNLISTED_SHARE * sum(times):
        return None
    return sum(times)


def pcm_bytes(run) -> int:
    """The window's delivered PCM: frames x channels x bytes a sample."""
    c = run.config
    return run.frames * c["channels"] * (c["bits_per_sample"] // 8)
