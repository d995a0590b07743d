"""K2's share of its roofline in the traced training steps: the bytes of the
gate updates' backward at the model's shapes, over the device time of
``gates_bwd_kernel``."""
from pvg_bench import counts


def read(reading):
    per_step = counts.gate_backward_bytes(reading.cell.config,
                                          reading.train_counts["gate_shapes"])
    return reading.kernel_share("gates_bwd_kernel", per_step,
                                reading.context.get("traced_steps", 0))
