"""K1's share of its roofline in the traced training steps: the bytes of the
step's ConvLSTM gate updates at the model's shapes, over the device time
of ``gates_fwd_kernel``."""
from pvg_bench import counts


def read(reading):
    per_step = counts.gate_forward_bytes(reading.cell.config, reading.train_counts["gate_shapes"])
    return reading.kernel_share("gates_fwd_kernel", per_step,
                                reading.context.get("traced_steps", 0))
