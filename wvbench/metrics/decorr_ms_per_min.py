"""decorr_ms_per_min (ms/min, device trace): the summed device time of
the decorrelation kernels (`csrc/decorr.cu`: every device operation of
the traced window's busiest whose name holds `decorr_`, the chain, split
and generic kernels alike), per minute of audio the window's calls
delivered. Nothing where the trace lists no such kernel."""

from wvbench.decorr_time import decorr_seconds


def read(run):
    s = decorr_seconds(run)
    if s is None or not run.frames:
        return None
    minutes = run.frames / run.config["sample_rate"] / 60.0
    return 1e3 * s / minutes
