"""The device's idle share in %, over the traced steps after the training
window: 1 - busy / window, both from the device-only trace."""


def read(reading):
    return reading.idle_share()
