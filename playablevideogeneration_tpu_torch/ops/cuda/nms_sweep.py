"""The greedy NMS sweep: a CUDA kernel and its plain version.

The kernel (``csrc/nms_sweep.cu``) replaces no Pallas kernel: it is the
counterpart of the ``lax.scan`` in the JAX package's ``nms_mask``
(``playablevideogeneration_tpu/evaluation/metrics/frcnn.py:277-301``),
which runs on the device inside the detector's ``jax.jit``.  It sweeps S
score-sorted candidate sets at once, one warp per set, so that the
detector's NMS stays on the device: a launch per NMS call instead of a
round trip to the host.  Its floor on an H100 is the chain of n dependent
steps of each set, not its bytes (each packed row read once: 8 MB, 2.5 us
at 3.35 TB/s, for the 64 sets of 1000 candidates of a 16-frame RPN call).

The rows are those of each set's sorted IoU > threshold matrix, packed
little-endian: column j in bit j % 8 of byte j // 8, each row padded to a
whole number of 32-bit words (``metrics.frcnn._packed_suppression``).
"""
from __future__ import annotations

import ctypes

import torch

from playablevideogeneration_tpu_torch.ops.cuda import build

# One warp's 32 lanes hold 32 bits each of a set's suppressed mask.
MAX_CANDIDATES = 1024
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int, ctypes.c_void_p]


def _nms_sweep(rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: rows (S, n, 4W) uint8 -> keep (S, n) bool,
    the sets swept together, one step per candidate, as the JAX scan
    steps: candidate i is kept unless bit i of the suppressed mask is set,
    and a kept candidate ORs its row into the mask."""
    sets, n, width = rows.shape
    words = rows.view(torch.int32)  # (S, n, W): column j in bit j % 32 of word j // 32
    suppressed = torch.zeros((sets, width // 4), dtype=torch.int32, device=rows.device)
    keep = torch.empty((sets, n), dtype=torch.bool, device=rows.device)
    for i in range(n):
        kept = ((suppressed[:, i // 32] >> (i % 32)) & 1) == 0
        keep[:, i] = kept
        suppressed |= torch.where(kept[:, None], words[:, i], 0)
    return keep


def _check(rows: torch.Tensor) -> None:
    if rows.dim() != 3 or rows.dtype != torch.uint8:
        raise ValueError(f"expected (S, n, bytes) uint8 rows, got {tuple(rows.shape)} "
                         f"{rows.dtype}")
    sets, n, width = rows.shape
    if n > MAX_CANDIDATES:
        raise ValueError(f"{n} candidates per set: the sweep takes at most {MAX_CANDIDATES}")
    if width % 4 or width * 8 < n:
        raise ValueError(f"rows of {width} bytes for {n} candidates: a row is a whole "
                         f"number of 32-bit words holding a bit per candidate")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    if rows.data_ptr() % 4:
        raise ValueError("rows must start on a 32-bit word")


def nms_sweep(rows: torch.Tensor) -> torch.Tensor:
    """Greedy NMS keep masks, in score order, of S score-sorted candidate
    sets given as the packed rows (S, n, 4W) uint8 of their IoU > threshold
    matrices (n <= 1024, W 32-bit words per row): (S, n) bool.

    Launches the CUDA kernel for CUDA tensors and runs ``_nms_sweep`` for
    CPU tensors; any other device raises.  ``nms_sweep.launches`` counts
    the kernel launches."""
    _check(rows)
    if rows.device.type == "cpu":
        return _nms_sweep(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    sets, n, width = rows.shape
    keep = torch.empty((sets, n), dtype=torch.bool, device=rows.device)
    if keep.numel() == 0:
        return keep
    fn = build.function("nms_sweep", "nms_sweep", _ARGTYPES)
    status = fn(rows.data_ptr(), keep.data_ptr(), sets, n, width // 4, rows.device.index,
                torch.cuda.current_stream(rows.device).cuda_stream)
    build.check(status, "nms_sweep", "nms_sweep")
    nms_sweep.launches += 1
    return keep


nms_sweep.launches = 0
