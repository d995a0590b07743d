"""Fused ConvLSTM gate update, forward and backward: CUDA kernels, their
plain versions and the autograd function around them.

Counterpart of ``playablevideogeneration_tpu/ops/pallas/convlstm_gates.py``.
The kernels (``csrc/convlstm_gates.cu``) replace the Pallas TPU kernels
``_fwd_kernel`` (its ``pl.pallas_call`` in ``_fwd_2d``) and ``_bwd_kernel``
(its ``pl.pallas_call`` in ``_bwd_2d``); ``_FusedGates`` is the counterpart
of the ``custom_vjp`` ``_fused_gates_pallas``, which saves (gates, c) and
recomputes the activations in the backward.

Both kernels are bound by memory traffic on an H100, with instruction
issue close behind at the training shapes: the forward reads the fused
4C-channel gate convolution's output and the cell state once and writes
only (h', c'), 14 bytes per state element in bf16; the backward reads
(gates, c, dh, dc) and writes (dgates, dc_prev), 24 bytes per state
element in bf16, 50 MB (15 us at 3.35 TB/s) for the flagship's 32x32x128
state at the training batch of 16.  Both walk each batch slice on a 2-D
grid, with a pack of 4 elements per stream and thread where
``build.vector_width`` allows it, one element per thread otherwise.

The kernels take channels-last storage, the model's, where a pixel's four
gates lie in one run of 4C; the wrappers raise on CUDA tensors stored
otherwise.  The plain versions, which run on the CPU, take channels-last
or contiguous NCHW tensors alike.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from playablevideogeneration_tpu_torch.ops.cuda import build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# Elements per thread of K1's and K2's packed paths (``kFwdPack`` and
# ``kBwdPack`` in the source).
_PACK = 4


def _argtypes(pointers: int) -> list:
    """A C entry point's arguments: the tensors, the batch, C*H*W, C, the
    elements per access, the device and the stream."""
    return [ctypes.c_void_p] * pointers + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_int,
                                                                   ctypes.c_void_p]


def _gate_math(gates: torch.Tensor, c: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward: gates (B, 4C, H, W) in i, f, o,
    g order and c (B, C, H, W) -> (h', c') in c's dtype, computed in f32 as
    the kernel computes it."""
    i, f, o, g = gates.float().chunk(4, dim=1)
    i, f, o, g = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), torch.tanh(g)
    new_c = f * c.float() + i * g
    new_h = o * torch.tanh(new_c)
    return new_h.to(c.dtype), new_c.to(c.dtype)


def _gate_math_bwd(gates: torch.Tensor, c: torch.Tensor, dh: torch.Tensor,
                   dc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: the formulas of the Pallas
    ``_bwd_kernel`` in f32, in the kernel's order of operations, with
    dgates in gates' dtype and dc_prev in c's dtype."""
    i, f, o, g = gates.float().chunk(4, dim=1)
    i, f, o, g = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), torch.tanh(g)
    cell = c.float()
    tanh_c = torch.tanh(f * cell + i * g)
    dh = dh.float()
    # d(c') takes the direct cotangent and the h' = o * tanh(c') path.
    d_new_c = dc.float() + dh * o * (1.0 - tanh_c * tanh_c)
    dgates = torch.cat([d_new_c * g * i * (1.0 - i),
                        d_new_c * cell * f * (1.0 - f),
                        dh * tanh_c * o * (1.0 - o),
                        d_new_c * i * (1.0 - g * g)], dim=1)
    return dgates.to(gates.dtype), (d_new_c * f).to(c.dtype)


def _check(gates: torch.Tensor, c: torch.Tensor, *state_like: torch.Tensor) -> None:
    """Shapes, dtypes, device and storage of gates (B, 4C, H, W) and of c
    and any further (B, C, H, W) tensors (the backward's dh, dc), and a
    batch slice of gates below 2**31 elements: channels-last storage for
    the kernels, and for the plain versions that or contiguous NCHW
    (``build.channels_last``)."""
    if c.dim() != 4 or gates.dim() != 4:
        raise ValueError(f"expected (B, 4C, H, W) gates and (B, C, H, W) c, got "
                         f"{tuple(gates.shape)} and {tuple(c.shape)}")
    b, ch, h, w = c.shape
    if tuple(gates.shape) != (b, 4 * ch, h, w):
        raise ValueError(f"gates {tuple(gates.shape)} does not match c "
                         f"{tuple(c.shape)}: expected {(b, 4 * ch, h, w)}")
    for t in state_like:
        if t.shape != c.shape:
            raise ValueError(f"cotangent {tuple(t.shape)} does not match c "
                             f"{tuple(c.shape)}")
    tensors = (gates, c) + state_like
    if c.dtype not in _SUFFIX or any(t.dtype != c.dtype for t in tensors):
        raise TypeError(f"gates, c and cotangents must all be float32 or bfloat16, "
                        f"got {[t.dtype for t in tensors]}")
    if any(t.device != c.device for t in tensors):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors]}")
    if not build.channels_last(*tensors) and c.device.type != "cpu":
        raise ValueError("the CUDA kernels take channels-last storage, got contiguous NCHW")
    slice_size = gates.shape[1:].numel()
    if slice_size >= 2 ** 31:  # the kernels' offsets inside a batch slice are 32-bit
        raise ValueError(f"a batch slice of gates holds {slice_size} elements, "
                         f"not below 2**31")
    if c.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {c.device}")


def _forward(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if c.device.type == "cpu":
        return _gate_math(gates, c)
    new_h = torch.empty_like(c)
    new_c = torch.empty_like(c)
    symbol = f"convlstm_gates_fwd_{_SUFFIX[c.dtype]}"
    fn = build.function("convlstm_gates", symbol, _argtypes(4))
    status = fn(gates.data_ptr(), c.data_ptr(), new_h.data_ptr(), new_c.data_ptr(),
                c.shape[0], c.shape[1:].numel(), c.shape[1],
                build.vector_width(c.shape[1], c, gates, new_h, new_c, elements=_PACK),
                c.device.index, torch.cuda.current_stream(c.device).cuda_stream)
    build.check(status, "convlstm_gates", symbol)
    fused_lstm_gates.launches += 1
    return new_h, new_c


def fused_lstm_gates_bwd(gates: torch.Tensor, c: torch.Tensor, dh: torch.Tensor,
                         dc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gate update's backward: (gates (B, 4C, H, W), c, dh, dc (B, C, H,
    W)) -> (dgates (B, 4C, H, W), dc_prev (B, C, H, W)).

    Launches the CUDA kernel K2 for CUDA tensors and runs ``_gate_math_bwd``
    for CPU tensors; any other device raises.  The outputs take the inputs'
    storage.  ``fused_lstm_gates_bwd.launches`` counts the kernel launches.
    """
    _check(gates, c, dh, dc)
    if c.device.type == "cpu":
        return _gate_math_bwd(gates, c, dh, dc)
    dgates = torch.empty_like(gates)
    dc_prev = torch.empty_like(c)
    width = build.vector_width(c.shape[1], c, gates, dh, dc, dgates, dc_prev, elements=_PACK)
    symbol = f"convlstm_gates_bwd_{_SUFFIX[c.dtype]}"
    fn = build.function("convlstm_gates", symbol, _argtypes(6))
    status = fn(gates.data_ptr(), c.data_ptr(), dh.data_ptr(), dc.data_ptr(),
                dgates.data_ptr(), dc_prev.data_ptr(), c.shape[0], c.shape[1:].numel(),
                c.shape[1], width, c.device.index,
                torch.cuda.current_stream(c.device).cuda_stream)
    build.check(status, "convlstm_gates", symbol)
    fused_lstm_gates_bwd.launches += 1
    return dgates, dc_prev


fused_lstm_gates_bwd.launches = 0


class _FusedGates(torch.autograd.Function):
    """The gate update with its fused backward: the forward saves only
    (gates, c), as the JAX custom VJP saves its residuals, and the
    backward recomputes the activations inside K2.  The cotangents are
    brought to the storage of (gates, c); one that no later computation
    produced (dc after the last step) is zeros made in that storage, which
    autograd's own zeros, contiguous NCHW, are not."""

    @staticmethod
    def forward(ctx, gates: torch.Tensor, c: torch.Tensor):
        ctx.save_for_backward(gates, c)
        ctx.set_materialize_grads(False)
        return _forward(gates, c)

    @staticmethod
    def backward(ctx, dh: Optional[torch.Tensor], dc: Optional[torch.Tensor]):
        gates, c = ctx.saved_tensors
        storage = (torch.channels_last if build.channels_last(gates, c)
                   else torch.contiguous_format)
        dh, dc = (torch.zeros_like(c) if d is None else d.contiguous(memory_format=storage)
                  for d in (dh, dc))
        return fused_lstm_gates_bwd(gates, c, dh, dc)


def fused_lstm_gates(gates: torch.Tensor, c: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates (B, 4C, H, W), c (B, C, H, W)) -> (h', c'), both (B, C, H, W).

    Launches the CUDA kernel K1 for CUDA tensors and runs ``_gate_math``
    for CPU tensors; any other device raises.  The outputs take the inputs'
    storage.  When autograd records the call, it goes through
    ``_FusedGates``, whose backward is K2 (or ``_gate_math_bwd`` on the
    CPU).  ``fused_lstm_gates.launches`` counts K1's launches.
    """
    _check(gates, c)
    if torch.is_grad_enabled() and (gates.requires_grad or c.requires_grad):
        return _FusedGates.apply(gates, c)
    return _forward(gates, c)


fused_lstm_gates.launches = 0
