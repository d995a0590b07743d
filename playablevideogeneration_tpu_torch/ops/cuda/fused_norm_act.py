"""Frozen-BatchNorm + LeakyReLU: a CUDA kernel and its plain version.

Counterpart of ``playablevideogeneration_tpu/ops/pallas/fused_norm_act.py``.
The kernel (``csrc/fused_norm_act.cu``) replaces the Pallas TPU kernel
``_kernel`` (its ``pl.pallas_call`` in ``fused_scale_shift_leaky_relu``)
and the fold its caller runs first: it takes the BatchNorm's raw scale,
bias, running mean and running variance, folds them into per-channel
a, b (rounded to x's dtype, as the JAX path rounds them) in registers, and
writes y = leaky_relu(x * a + b) in one pass over x, so a call is one
launch.  Its bound on an H100 is memory traffic: 4 bytes per element in
bf16, 8.4 MB (2.5 us at 3.35 TB/s) at the flagship's largest shape,
256x256x32.

The kernel takes channels-last storage, the model's, and walks a batch
row of H*W*C, with every channel folded once per block into shared
memory; the wrapper raises on a CUDA x stored otherwise.  The plain
version, which runs on the CPU, takes channels-last or contiguous NCHW
alike.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from playablevideogeneration_tpu_torch.ops.cuda import build

NEGATIVE_SLOPE = 0.2
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def fold_batch_norm(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
                    var: torch.Tensor, eps: float = 1e-5
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN(frozen statistics) == x * a + b."""
    a = scale / torch.sqrt(var + eps)
    return a, bias - mean * a


def _batch_norm_leaky_relu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5
                           ) -> torch.Tensor:
    """Plain PyTorch version: the f32 fold, a and b rounded to x's dtype,
    f32 math, x's dtype out."""
    a, b = fold_batch_norm(scale, bias, mean, var, eps)
    a, b = a.to(x.dtype).float(), b.to(x.dtype).float()
    y = x.float() * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
    return torch.where(y >= 0, y, y * NEGATIVE_SLOPE).to(x.dtype)


# The most channels the kernel takes: its block holds every channel's
# folded coefficients in shared memory (``kMaxChannels``).
MAX_CHANNELS = 6144


def _check(x: torch.Tensor, statistics: Tuple[torch.Tensor, ...]) -> None:
    """Shapes, dtypes, devices and storage of x (B, C, H, W) and of the
    statistics: channels-last storage for the kernel, and for the plain
    version that or contiguous NCHW (``build.channels_last``)."""
    if x.dim() != 4:
        raise ValueError(f"expected a (B, C, H, W) x, got {tuple(x.shape)}")
    channels = x.shape[1]
    if any(tuple(s.shape) != (channels,) for s in statistics):
        raise ValueError(f"scale, bias, mean and var {[tuple(s.shape) for s in statistics]} "
                         f"must be ({channels},) for x {tuple(x.shape)}")
    # The kernel counts batch rows and offsets inside a row in 32 bits.
    if x.shape[0] >= 2 ** 31 or x.shape[1:].numel() >= 2 ** 31:
        raise ValueError(f"x {tuple(x.shape)} must have below 2**31 batch rows of below "
                         f"2**31 elements")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if any(s.dtype != torch.float32 for s in statistics):
        raise TypeError(f"scale, bias, mean and var must be float32, got "
                        f"{[s.dtype for s in statistics]}")
    if any(s.device != x.device for s in statistics):
        raise ValueError(f"x on {x.device}, statistics on {[str(s.device) for s in statistics]}")
    if not all(s.is_contiguous() for s in statistics):
        raise ValueError("scale, bias, mean and var must be contiguous")
    if not build.channels_last(x) and x.device.type != "cpu":
        raise ValueError("the CUDA kernel takes channels-last storage, got contiguous NCHW")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda" and channels > MAX_CHANNELS:
        raise ValueError(f"the CUDA kernel takes at most {MAX_CHANNELS} channels, got "
                         f"{channels}")


def fused_batch_norm_leaky_relu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                                mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5
                                ) -> torch.Tensor:
    """leaky_relu(BatchNorm(x), 0.2) with frozen statistics, for x (B, C, H, W)
    and the BatchNorm's f32 scale, bias, running mean and running variance,
    each of shape (C,).

    Launches the CUDA kernel (fold included) for CUDA tensors and runs
    ``_batch_norm_leaky_relu`` for CPU tensors; any other device raises.
    y takes x's storage.  ``fused_batch_norm_leaky_relu.launches`` counts
    the kernel launches.
    """
    statistics = (scale, bias, mean, var)
    _check(x, statistics)
    if x.device.type == "cpu":
        return _batch_norm_leaky_relu(x, *statistics, eps)
    y = torch.empty_like(x)
    channels = x.shape[1]
    symbol = f"batch_norm_leaky_relu_{_SUFFIX[x.dtype]}"
    fn = build.function("fused_norm_act", symbol, _ARGTYPES)
    # B batch rows of H*W*C, packs inside a pixel's C.
    status = fn(x.data_ptr(), *(s.data_ptr() for s in statistics), y.data_ptr(),
                x.shape[0], channels, x.shape[1:].numel(), eps, NEGATIVE_SLOPE,
                build.vector_width(channels, x, y, elements=16 // x.element_size()),
                x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "fused_norm_act", symbol)
    fused_batch_norm_leaky_relu.launches += 1
    return y


fused_batch_norm_leaky_relu.launches = 0
