"""The training step's share of the card's dense bf16 peak: the step's
floating-point operations (forward, perceptual loss and backward, counted
on the reference) times the steps of the window, over the window."""
from pvg_bench import counts


def read(reading):
    c = reading.context
    if not c.get("steps"):
        return None
    flops = reading.train_counts["flops"] * c["steps"]
    return 100.0 * flops / c["window_s"] / counts.peak_flops(reading.cell.config)
