"""setup_s (s, host clock): from the process's start to the window's
start: imports and the CUDA context, kernel libraries loaded or built,
inputs made, warm-up calls."""


def read(run):
    return run.setup_s
