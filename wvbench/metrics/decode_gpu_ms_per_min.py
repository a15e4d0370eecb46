"""decode_gpu_ms_per_min (ms/min, device trace): the summed device time
of every kernel the window's calls ran (copies left out), per minute of
audio they delivered: the card's time a decode takes from whatever else
shares the card, such as the training job an audio loader feeds.
Nothing without device kernels."""


def read(run):
    if run.op != "decode" or not run.kernel_s or not run.frames:
        return None
    minutes = run.frames / run.config["sample_rate"] / 60.0
    return 1e3 * run.kernel_s / minutes
