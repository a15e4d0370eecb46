"""Transfer-byte accounting for the delivery path (port of
wvpk/engine/xferstats.py).

`staging.bucket_tensors` and `dsd_pipeline.group_tensors` add the bytes
they stage to the device (h2d) and `pipeline._finish_fetch` the bytes of
each batched device-to-host copy (d2h). Counting happens on the host when
a copy is queued: it is the payload byte count, not a measurement of the
link."""

counters = {"h2d": 0, "d2h": 0}


def reset() -> None:
    counters["h2d"] = 0
    counters["d2h"] = 0


def add(direction: str, nbytes: int) -> None:
    counters[direction] += int(nbytes)
