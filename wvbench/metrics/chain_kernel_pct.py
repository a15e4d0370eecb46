"""chain_kernel_pct (%, program counters on a span): the share of the PCM
lanes the port launched (`launch#lanes`) whose decorrelation chain routes
them to a kernel compiled for that chain (`launch#chain_lanes`: a chain
of `csrc/decorr.cu`'s tables, its weights and rings in registers) rather
than to the generic kernel, which reads each lane's chain at run time;
over the traced window's calls. Nothing where the program has no such
counter."""


def read(run):
    lanes = run.stages.get("launch#lanes", 0)
    if run.op != "decode" or not lanes > 0 \
            or "launch#chain_lanes" not in run.stages:
        return None
    return 100.0 * run.stages["launch#chain_lanes"] / lanes
