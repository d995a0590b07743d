"""Milliseconds per step that the window waited on ``next()`` of
``Trainer.dataloader`` (the benchmark's own span, host clock)."""


def read(reading):
    c = reading.context
    return 1e3 * c["loader_wait_s"] / c["steps"] if c.get("steps") else None
