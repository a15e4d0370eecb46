"""enc_wait_ms (ms a call, program span): the port's encode device waits,
`enc_warm.fetch` (the warm state's copy, which waits for the warm scan)
plus `enc_fetch` (the bit totals' copy, which waits for the main scans),
summed over the traced window's calls, over the calls; nothing where the
program has no `enc_warm.fetch` span."""


def read(run):
    if run.op != "encode" or not run.calls \
            or "enc_warm.fetch" not in run.stages:
        return None
    v = run.stages["enc_warm.fetch"] + run.stages.get("enc_fetch", 0.0)
    return v / run.calls * 1e3 if v > 0 else None
