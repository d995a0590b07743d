"""Frozen-BatchNorm + LeakyReLU epilogue: a CUDA kernel and its plain version.

Counterpart of ``playablevideogeneration_tpu/ops/pallas/fused_norm_act.py``.
The kernel (``csrc/fused_norm_act.cu``) replaces the Pallas TPU kernel
``_kernel`` (its ``pl.pallas_call`` in ``fused_scale_shift_leaky_relu``):
y = leaky_relu(x * a + b) with the frozen statistics folded into per-channel
a, b by ``fold_batch_norm``, in one pass over x.  Its bound on an H100 is
memory traffic: 4 bytes per element in bf16, 8.4 MB (2.5 us at 3.35 TB/s)
at the flagship's largest shape, 256x256x32.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from playablevideogeneration_tpu_torch.ops.cuda import build

NEGATIVE_SLOPE = 0.2
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def fold_batch_norm(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
                    var: torch.Tensor, eps: float = 1e-5
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN(frozen statistics) == x * a + b."""
    a = scale / torch.sqrt(var + eps)
    return a, bias - mean * a


def _scale_shift_leaky_relu(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                            ) -> torch.Tensor:
    """Plain PyTorch version: f32 math, x's dtype out."""
    y = x.float() * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
    return torch.where(y >= 0, y, y * NEGATIVE_SLOPE).to(x.dtype)


def _check(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected an NCHW x, got {tuple(x.shape)}")
    channels = x.shape[1]
    if tuple(a.shape) != (channels,) or tuple(b.shape) != (channels,):
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must be "
                         f"({channels},) for x {tuple(x.shape)}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"a and b must be float32, got {a.dtype} and {b.dtype}")
    if not (a.device == b.device == x.device):
        raise ValueError(f"x, a, b on {x.device}, {a.device}, {b.device}")
    if not (x.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("x, a and b must be contiguous")


def fused_scale_shift_leaky_relu(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                                 ) -> torch.Tensor:
    """y = leaky_relu(x * a + b, 0.2) for x (B, C, H, W) and f32 a, b of shape (C,).

    Launches the CUDA kernel for CUDA tensors and runs the plain version for
    CPU tensors; any other device raises.
    ``fused_scale_shift_leaky_relu.launches`` counts the kernel launches.
    """
    _check(x, a, b)
    if x.device.type == "cpu":
        return _scale_shift_leaky_relu(x, a, b)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    y = torch.empty_like(x)
    symbol = f"scale_shift_leaky_relu_{_SUFFIX[x.dtype]}"
    fn = build.function("fused_norm_act", symbol, _ARGTYPES)
    status = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel(),
                x.shape[2] * x.shape[3], x.shape[1], NEGATIVE_SLOPE, x.device.index,
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "fused_norm_act", symbol)
    fused_scale_shift_leaky_relu.launches += 1
    return y


fused_scale_shift_leaky_relu.launches = 0
