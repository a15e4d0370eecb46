"""staging_ms (ms a call, program span): the port's `trace.collect()`
stage "staging" summed over the traced window's calls, over the calls."""


def read(run):
    if run.op != "decode" or not run.calls or "staging" not in run.stages:
        return None
    return run.stages["staging"] / run.calls * 1e3
