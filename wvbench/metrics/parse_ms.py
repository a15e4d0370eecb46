"""parse_ms (ms a call, program span): the benchmark's own span around
`container.parse_blocks` for every file of a call."""


def read(run):
    if run.op != "decode" or not run.calls or "parse" not in run.spans:
        return None
    return run.spans["parse"] / run.calls * 1e3
