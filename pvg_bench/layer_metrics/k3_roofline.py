"""K3's share of its roofline in the traced play frames: the bytes of the
play step's frozen BatchNorm + LeakyReLU pairs, over the device time of
``batch_norm_leaky_relu_kernel``."""
from pvg_bench import counts


def read(reading):
    per_frame = counts.norm_bytes(reading.cell.config, reading.play_counts["norm_shapes"])
    return reading.kernel_share("batch_norm_leaky_relu_kernel", per_frame,
                                reading.context.get("traced_frames", 0))
