"""Milliseconds of host work that a detector call adds after its device
work: the window's mean, per call, of the port's spans ``detect.boxes``
(the 0.8 threshold and the boxes as tuples) and ``detect.select`` (the
court filter and the tallest box), from their tallies just before and
after the window."""


def read(reading):
    seconds = reading.context.get("detect_host_s")
    return None if seconds is None else 1e3 * seconds
