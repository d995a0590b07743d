"""Fused ConvLSTM gate update (forward): a CUDA kernel and its plain version.

Counterpart of ``playablevideogeneration_tpu/ops/pallas/convlstm_gates.py``.
The kernel (``csrc/convlstm_gates.cu``) replaces the Pallas TPU kernel
``_fwd_kernel`` (its ``pl.pallas_call`` in ``_fwd_2d``).  It reads the fused
4C-channel gate convolution's output and the cell state once and writes only
(h', c').  Its bound on an H100 is memory traffic: 14 bytes per state element
in bf16, about 1.8 MB (0.55 us at 3.35 TB/s) for the flagship's 32x32x128
state, which is below the cost of a launch.

The backward kernel of the JAX package (``_bwd_kernel``) belongs to the
training route and is not ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from playablevideogeneration_tpu_torch.ops.cuda import build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_void_p]


def _gate_math(gates: torch.Tensor, c: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: gates (B, 4C, H, W) in i, f, o, g order and
    c (B, C, H, W) -> (h', c') in c's dtype, computed in f32 as the kernel
    computes it."""
    i, f, o, g = gates.float().chunk(4, dim=1)
    i, f, o, g = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), torch.tanh(g)
    new_c = f * c.float() + i * g
    new_h = o * torch.tanh(new_c)
    return new_h.to(c.dtype), new_c.to(c.dtype)


def _check(gates: torch.Tensor, c: torch.Tensor) -> None:
    if c.dim() != 4 or gates.dim() != 4:
        raise ValueError(f"expected NCHW gates and c, got {tuple(gates.shape)} "
                         f"and {tuple(c.shape)}")
    b, ch, h, w = c.shape
    if tuple(gates.shape) != (b, 4 * ch, h, w):
        raise ValueError(f"gates {tuple(gates.shape)} does not match c "
                         f"{tuple(c.shape)}: expected {(b, 4 * ch, h, w)}")
    if c.dtype not in _SUFFIX or gates.dtype != c.dtype:
        raise TypeError(f"gates and c must both be float32 or bfloat16, got "
                        f"{gates.dtype} and {c.dtype}")
    if gates.device != c.device:
        raise ValueError(f"gates on {gates.device} but c on {c.device}")
    if not (gates.is_contiguous() and c.is_contiguous()):
        raise ValueError("gates and c must be contiguous NCHW tensors")


def fused_lstm_gates(gates: torch.Tensor, c: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates (B, 4C, H, W), c (B, C, H, W)) -> (h', c'), both (B, C, H, W).

    Launches the CUDA kernel for CUDA tensors and runs ``_gate_math`` for
    CPU tensors; any other device raises.  ``fused_lstm_gates.launches``
    counts the kernel launches.
    """
    _check(gates, c)
    if c.device.type == "cpu":
        return _gate_math(gates, c)
    if c.device.type != "cuda":
        raise ValueError(f"unsupported device {c.device}")
    new_h = torch.empty_like(c)
    new_c = torch.empty_like(c)
    symbol = f"convlstm_gates_fwd_{_SUFFIX[c.dtype]}"
    fn = build.function("convlstm_gates", symbol, _ARGTYPES)
    status = fn(gates.data_ptr(), c.data_ptr(), new_h.data_ptr(), new_c.data_ptr(),
                c.numel(), c.shape[1] * c.shape[2] * c.shape[3], c.device.index,
                torch.cuda.current_stream(c.device).cuda_stream)
    build.check(status, "convlstm_gates", symbol)
    fused_lstm_gates.launches += 1
    return new_h, new_c


fused_lstm_gates.launches = 0
