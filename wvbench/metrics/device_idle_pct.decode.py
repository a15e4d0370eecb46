"""device_idle_pct.decode (%, device trace): the share of the traced window
in which no kernel or copy runs on the card; nothing without a device
event."""


def read(run):
    if run.op != "decode" or run.trace is None or not run.trace["busy_s"] > 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
