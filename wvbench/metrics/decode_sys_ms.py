"""decode_sys_ms (ms a call, program counter on a span): the decoding
thread's system CPU time over the port's `decode` span (`decode#stime_us`:
the kernel's share of staging, launch, delivery and finalize, most of it
the page faults of host buffers the call maps fresh), summed over the
traced window's calls, over the calls; nothing where the program has no
such counter."""


def read(run):
    if run.op != "decode" or not run.calls \
            or "decode#stime_us" not in run.stages:
        return None
    return run.stages["decode#stime_us"] / run.calls / 1e3
