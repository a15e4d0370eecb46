"""decorr_roofline (%, device trace): the least time the window's
delivered PCM takes at the card's HBM peak (frames x channels x bytes a
sample, counted from the data: the least any implementation of the
chain writes, wherever its residuals come from) over the decorrelation
kernels' summed device time (decorr_time.py). Nothing where the trace
lists no decorrelation kernel."""

from wvbench.decorr_time import decorr_seconds, pcm_bytes
from wvbench.roofline import roofline_pct


def read(run):
    s = decorr_seconds(run)
    if s is None or not run.frames:
        return None
    return roofline_pct(pcm_bytes(run), s)
