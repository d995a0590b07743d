"""Milliseconds of a frame that are not device time: the window's mean
``generate_next_u8`` latency less the device's busy time per traced frame
(the input copies, the replay's launch, the readback and the sync)."""


def read(reading):
    c = reading.context
    if reading.trace is None or not c.get("latencies_s") or not c.get("traced_frames"):
        return None
    mean = sum(c["latencies_s"]) / len(c["latencies_s"])
    return 1e3 * (mean - reading.trace.busy_s / c["traced_frames"])
