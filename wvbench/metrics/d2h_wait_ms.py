"""d2h_wait_ms (ms a call, program span): the port's `transfer.wait` span
(`engine/pipeline.py`: the host blocked on the call's queued device work
before the result copy) summed over the traced window's calls, over the
calls; nothing where the program has no such span."""


def read(run):
    v = run.stages.get("transfer.wait", 0.0)
    if run.op != "decode" or not run.calls or not v > 0:
        return None
    return v / run.calls * 1e3
