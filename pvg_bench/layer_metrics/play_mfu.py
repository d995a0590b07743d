"""The play step's share of the card's dense bf16 peak: the forward's
floating-point operations at batch 1 (counted on the reference) times the
frames delivered in the window, over the window."""
from pvg_bench import counts


def read(reading):
    c = reading.context
    if not c.get("frames"):
        return None
    flops = reading.play_counts["flops"] * c["frames"]
    return 100.0 * flops / c["window_s"] / counts.peak_flops(reading.cell.config)
