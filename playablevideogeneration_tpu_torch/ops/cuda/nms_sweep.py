"""Greedy NMS of score-sorted candidate sets: CUDA kernels and their plain
version.

The kernels (``csrc/nms_sweep.cu``) replace no Pallas kernel: they are the
counterpart of the JAX package's ``nms_mask`` after its ``argsort``
(``playablevideogeneration_tpu/evaluation/metrics/frcnn.py:277-301``): the
IoU of the sorted boxes, the > threshold test and the ``lax.scan``, which
run on the device inside the detector's ``jax.jit``.  ``nms_keep`` takes S
sets of n <= 1024 score-sorted boxes and launches two kernels on the
current stream: the first packs each set's IoU > threshold rows to bits
into a scratch of S x n x 32 words at most (8 MB for the 64 sets of 1000
candidates of a 16-frame RPN call, held in L2 until the second reads
it), the second sweeps them, one warp per set.  Nothing n x n is built in
f32 or in bytes on the card.  The mask's floor on an H100 is its
n(n - 1) / 2 IoUs per set at the f32 rate; the sweep's the chain of n
dependent steps of each set.

The plain version (``_nms_keep``, for CPU tensors and the comparison on
the card) is ``_packed_rows`` (``box_iou``, the threshold, the packing)
then ``_nms_sweep``.  Rows are packed little-endian: column j in bit j % 8
of byte j // 8, each row padded to a whole number of 32-bit words.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from playablevideogeneration_tpu_torch.ops.cuda import build

# One warp's 32 lanes hold 32 bits each of a set's suppressed mask.
MAX_CANDIDATES = 1024
# The mask kernel's, then the sweep's.
LAUNCHES_PER_CALL = 2
_MASK_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                  ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_SWEEP_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :] - inter, min=1e-9)


def _packed_rows(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Score-sorted boxes (..., n, 4) -> the (..., n, 4 ceil(n / 32)) uint8
    rows of their IoU > threshold matrix, column j in bit j % 8 of byte
    j // 8: each row a whole number of little-endian 32-bit words."""
    over = (box_iou(boxes, boxes) > iou_threshold).to(torch.uint8)
    over = F.pad(over, (0, -over.shape[-1] % 32))
    bits = (1 << torch.arange(8, device=over.device)).to(torch.uint8)
    return (over.view(*over.shape[:-1], -1, 8) * bits).sum(-1, dtype=torch.uint8)


def _nms_sweep(rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch sweep: rows (S, n, 4W) uint8 -> keep (S, n) bool,
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


def _nms_keep(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch version of ``nms_keep``."""
    return _nms_sweep(_packed_rows(boxes, iou_threshold))


def _check(boxes: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"expected (S, n, 4) float32 boxes, got {tuple(boxes.shape)} "
                         f"{boxes.dtype}")
    if boxes.shape[1] > MAX_CANDIDATES:
        raise ValueError(f"{boxes.shape[1]} candidates per set: the kernels take at most "
                         f"{MAX_CANDIDATES}")
    if not boxes.is_contiguous():
        raise ValueError("boxes must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must start on a 16-byte boundary")


def _launch(symbol: str, argtypes, *args) -> None:
    """Calls the C entry point ``symbol``, which launches one kernel, and
    counts the launch."""
    build.check(build.function("nms_sweep", symbol, argtypes)(*args), "nms_sweep", symbol)
    nms_keep.launches += 1


def _mask(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The mask kernel: CUDA boxes (S, n, 4) -> (S, n, W) int32 packed
    rows, W = ceil(n / 32) rounded up to a multiple of 4, so that the sweep
    fetches 16-byte pieces.  Only the words at or right of each row's
    diagonal word are written."""
    sets, n, _ = boxes.shape
    words = -(-n // 128) * 4
    rows = torch.empty((sets, n, words), dtype=torch.int32, device=boxes.device)
    _launch("nms_mask", _MASK_ARGTYPES, boxes.data_ptr(), rows.data_ptr(), sets, n, words,
            iou_threshold, boxes.device.index,
            torch.cuda.current_stream(boxes.device).cuda_stream)
    return rows


def _sweep(rows: torch.Tensor) -> torch.Tensor:
    """The sweep kernel: CUDA packed rows (S, n, W) int32, contiguous ->
    keep (S, n) bool."""
    sets, n, words = rows.shape
    keep = torch.empty((sets, n), dtype=torch.bool, device=rows.device)
    _launch("nms_sweep", _SWEEP_ARGTYPES, rows.data_ptr(), keep.data_ptr(), sets, n, words,
            rows.device.index, torch.cuda.current_stream(rows.device).cuda_stream)
    return keep


def nms_keep(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep masks, in score order, of S score-sorted candidate
    sets given as their boxes (S, n, 4) float32 (x1, y1, x2, y2; n <=
    1024): (S, n) bool, candidate i kept unless a kept candidate before it
    has IoU > ``iou_threshold`` (compared in f32) with it.

    Launches the two CUDA kernels for CUDA tensors and runs ``_nms_keep``
    for CPU tensors; any other device raises.  ``nms_keep.launches``
    counts the kernel launches (``LAUNCHES_PER_CALL`` per call)."""
    _check(boxes)
    if boxes.device.type == "cpu":
        return _nms_keep(boxes, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if boxes.numel() == 0:
        return torch.empty(boxes.shape[:2], dtype=torch.bool, device=boxes.device)
    return _sweep(_mask(boxes, iou_threshold))


nms_keep.launches = 0
