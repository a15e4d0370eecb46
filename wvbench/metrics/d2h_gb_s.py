"""d2h_gb_s (GB/s, program span): the bytes the port's result copies
moved into host memory (its `transfer.copy#bytes` counter) over the time
of its `transfer.copy` spans, over the traced window; nothing without a
device in the trace (a CPU run copies nothing) or without the span."""


def read(run):
    if run.op != "decode" or run.trace is None \
            or not run.trace["busy_s"] > 0:
        return None
    secs = run.stages.get("transfer.copy", 0.0)
    nbytes = run.stages.get("transfer.copy#bytes", 0)
    if not secs > 0 or not nbytes > 0:
        return None
    return nbytes / secs / 1e9
