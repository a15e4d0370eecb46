"""enc_assemble_ms (ms a call, program span): the port's
`trace.collect()` stages enc_pack + enc_assemble (payload packing and
block assembly) summed over the traced window's calls, over the calls."""


def read(run):
    if run.op != "encode" or not run.calls \
            or "enc_assemble" not in run.stages:
        return None
    return (run.stages.get("enc_pack", 0.0) + run.stages["enc_assemble"]) \
        / run.calls * 1e3
