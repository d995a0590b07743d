"""K1's share of its roofline in the traced play frames: the bytes of the
play step's 3 gate updates, over the device time of ``gates_fwd_kernel``."""
from pvg_bench import counts


def read(reading):
    per_frame = counts.gate_forward_bytes(reading.cell.config, reading.play_counts["gate_shapes"])
    return reading.kernel_share("gates_fwd_kernel", per_frame,
                                reading.context.get("traced_frames", 0))
