"""The device's idle share in %, over the traced requests after the play
window: 1 - busy / window, both from the device-only trace."""


def read(reading):
    return reading.idle_share()
