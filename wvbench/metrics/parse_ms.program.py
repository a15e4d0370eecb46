"""parse_ms.program (ms a call, program span): the port's own `parse` span
(`container.parse_blocks`, one a file) summed over the traced window's
calls, over the calls; nothing where the program has no such span."""


def read(run):
    v = run.stages.get("parse", 0.0)
    if run.op != "decode" or not run.calls or not v > 0:
        return None
    return v / run.calls * 1e3
