"""K4's share of its roofline in the traced calls: the greedy NMS's
operations at the call's set sizes (14 f32 operations per unordered pair)
at the card's f32 rate, over the device time of ``nms_mask_kernel`` and
``nms_sweep_kernel``."""
from pvg_bench import detect_counts

KERNELS = ("nms_mask_kernel", "nms_sweep_kernel")


def read(reading):
    calls = reading.context.get("traced_calls")
    if reading.trace is None or not calls:
        return None
    measured = reading.trace.device_seconds(lambda name: any(k in name for k in KERNELS))
    if measured <= 0:
        return None
    ops = detect_counts.nms_ops(reading.cell.config) * calls
    return 100.0 * ops / detect_counts.PEAK_F32_FLOPS / measured
