"""decode_msamples_s.traced (Msamples/s, host clock): frames the block
headers count, delivered to host memory with every block's status, over
all calls of the traced window and all its time (a frame is a sample of
every channel). The rate a user sees, read in the traced run: the host's
speed drifts from run to run by more than a bound can hold."""


def read(run):
    if run.op != "decode" or run.trace is None or not run.window_s > 0:
        return None
    return run.frames / run.window_s / 1e6
