"""enc_stage_ms (ms a call, program span): the port's `trace.collect()`
stages enc_prep + enc_meta (staging the lanes, building the spec and
metadata) summed over the traced window's calls, over the calls."""


def read(run):
    if run.op != "encode" or not run.calls or "enc_prep" not in run.stages:
        return None
    return (run.stages["enc_prep"] + run.stages.get("enc_meta", 0.0)) \
        / run.calls * 1e3
