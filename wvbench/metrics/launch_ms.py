"""launch_ms (ms a call, program span): the port's `trace.collect()`
stage "launch" summed over the traced window's calls, over the calls."""


def read(run):
    if run.op != "decode" or not run.calls or "launch" not in run.stages:
        return None
    return run.stages["launch"] / run.calls * 1e3
