"""The detector's share of the card's dense TF32 peak: the operations of
the convolutions and products of one call (counted on the reference at the
RoIs that the program's static shapes run) times the window's calls, over
the window."""
from pvg_bench import detect_counts


def read(reading):
    c = reading.context
    if not c.get("requests"):
        return None
    flops = detect_counts.call_flops(reading.cell.config) * c["requests"]
    return 100.0 * flops / c["window_s"] / detect_counts.PEAK_TF32_FLOPS
