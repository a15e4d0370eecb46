"""encode_msamples_s (Msamples/s, host clock): frames that
`encode.encode_device` turned into `.wv` bytes in host memory, over all
calls of the window and all its time."""


def read(run):
    if run.op != "encode" or not run.window_s > 0:
        return None
    return run.frames / run.window_s / 1e6
