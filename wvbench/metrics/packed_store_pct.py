"""packed_store_pct (%, program counters on a span): the share of the PCM
lanes the port launched (`launch#lanes`) whose delivered payload its
decorrelation kernel wrote packed (`launch#packed_lanes`: the packed store
of `csrc/decorr.cu`, which folds the mute mask, fixup and byte pack into
the kernel), over the traced window's calls; nothing where the program has
no such counters."""


def read(run):
    lanes = run.stages.get("launch#lanes", 0)
    if run.op != "decode" or not lanes > 0 \
            or "launch#packed_lanes" not in run.stages:
        return None
    return 100.0 * run.stages["launch#packed_lanes"] / lanes
