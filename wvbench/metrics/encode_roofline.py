"""encode_roofline (%, device trace): the least time the call's bytes
take at the card's HBM peak (roofline.py: counted from the data) over the
summed device time of every kernel in the traced window (copies left
out); nothing without device kernels."""

from wvbench.roofline import roofline_pct


def read(run):
    if run.op != "encode" or run.trace is None:
        return None
    return roofline_pct(run.bytes, run.trace["kernel_s"])
