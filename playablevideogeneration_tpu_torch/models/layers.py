"""Convolutional building blocks in channels-last storage.

Counterpart of ``playablevideogeneration_tpu/models/layers.py``; submodules
carry the Flax names (``conv1``, ``bn1``, ``shortcut_conv``, ``cell.gates``
...) so the weight bridge (``utils/jax_weights.py``) is a renaming.

Activations are indexed (N, C, H, W) and stored channels-last
(``torch.channels_last``), as the JAX package's NHWC arrays are, and a
convolution's weight is stored channels-last from its construction on, so
that cuDNN runs its NHWC convolutions with no transposing copy of an input,
an output or a filter.  Where ``torch.cat`` would fall back to
channels-first, the blocks join tensors with ``utils.tensor_ops.cat``.

Parameters are f32 and the blocks compute in their ``dtype``, as every
JAX layer does with ``param_dtype=float32``: a convolution casts its f32
weights to the compute dtype in ``forward``, so the gradients and the
optimizer stay in f32.

A BatchNorm follows its module's ``training`` flag: in training it
normalises with the batch statistics and folds them into its running
statistics as flax does; in evaluation it uses the running statistics, and
a BatchNorm followed by LeakyReLU runs as the fused CUDA epilogue
(``ops/cuda/fused_norm_act.py``), as the JAX package selects
``_FrozenBNLeakyRelu``.  The ConvLSTM gate update runs as the fused CUDA
gate kernels (``ops/cuda/convlstm_gates.py``), forward and backward.

The JAX package's TPU layout rewrites (``_SubpixelConv``, ``_FusedUpConv``,
the deconv and phase forms of the x2 bilinear, activation tags for remat)
compute the plain op tap for tap, so the port has only the plain op.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from playablevideogeneration_tpu_torch.ops.cuda.convlstm_gates import fused_lstm_gates
from playablevideogeneration_tpu_torch.ops.cuda.fused_norm_act import (
    NEGATIVE_SLOPE,
    fused_batch_norm_leaky_relu,
)
from playablevideogeneration_tpu_torch.parallel import mesh
from playablevideogeneration_tpu_torch.utils import tensor_ops as tops

EPS = 1e-5
# flax's BatchNorm(momentum=0.9) keeps 0.9 of the running statistic per
# update: torch's BatchNorm2d calls the same average momentum=0.1.
MOMENTUM = 0.9


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU with the reference's fixed negative slope 0.2."""
    return F.leaky_relu(x, NEGATIVE_SLOPE)


def avg_pool(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average pool with window == stride == factor (identity for factor 1)."""
    return x if factor == 1 else F.avg_pool2d(x, factor)


def upsample_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear x``scale`` upsampling, half-pixel centres (align_corners=False)."""
    return F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=False)


class _CastParameters:
    """f32 ``weight`` and ``bias`` used in ``compute_dtype``.

    When the parameter takes a gradient, the cast is part of the graph, so
    the gradient stays f32.  Otherwise (gradients off, as on the play
    route, or a frozen parameter, as in VGG) a cast is kept and reused
    while its parameter is unchanged (same storage, same version counter,
    which every in-place update such as an optimizer step advances), so
    such a call launches no casts."""

    compute_dtype: torch.dtype

    def _cast(self, name: str) -> Optional[torch.Tensor]:
        p = getattr(self, name)
        if (p is None or p.dtype == self.compute_dtype
                or (torch.is_grad_enabled() and p.requires_grad)):
            return None if p is None else p.to(self.compute_dtype)
        key = (p.data_ptr(), p._version)
        cached = self.__dict__.setdefault("_casts", {}).get(name)
        if cached is None or cached[0] != key:
            cached = (key, p.detach().to(self.compute_dtype))
            self._casts[name] = cached
        return cached[1]


class Conv2d(_CastParameters, nn.Conv2d):
    """Stride-1 conv with Flax ``SAME`` padding for an odd kernel, f32
    parameters and ``dtype`` compute."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int, bias: bool,
                 dtype: torch.dtype):
        super().__init__(in_planes, out_planes, kernel_size, padding=kernel_size // 2,
                         bias=bias)
        self.weight = nn.Parameter(self.weight.detach().contiguous(
            memory_format=torch.channels_last))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.compute_dtype), self._cast("weight"), self._cast("bias"),
                        padding=self.padding)


class Linear(_CastParameters, nn.Linear):
    """Dense layer with f32 parameters and ``dtype`` compute (flax
    ``nn.Dense(dtype=..., param_dtype=float32)``)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.compute_dtype), self._cast("weight"), self._cast("bias"))


class ColumnParallel(_CastParameters, nn.Module):
    """A ``Conv2d`` or ``Linear`` whose output channels are split over the
    model group: the counterpart of a kernel that the JAX package's
    ``param_shardings`` shards ``P(..., 'model')``.

    It holds the f32 master slice ``weight[m * O / M:(m + 1) * O / M]`` of
    model index ``m`` (JAX's contiguous block) and the full, replicated
    bias, which ``param_shardings`` leaves unsharded.  Its forward is
    ``copy_to_model`` -> the layer on the slice -> ``gather_from_model`` ->
    ``+ bias``, so what follows sees the full output on every rank.  Build
    it with ``shard_model``.
    """

    def __init__(self, layer: nn.Module, info: mesh.MeshInfo):
        super().__init__()
        rows = layer.weight.shape[0] // info.model_size
        start = info.model_index * rows
        self.weight = nn.Parameter(layer.weight.detach()[start:start + rows].clone())
        self.bias = layer.bias
        self.compute_dtype = layer.compute_dtype
        self.padding = layer.padding if isinstance(layer, nn.Conv2d) else None
        self.info = info

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = mesh.copy_to_model(x.to(self.compute_dtype), self.info)
        if self.padding is None:
            y = mesh.gather_from_model(F.linear(x, self._cast("weight")), -1, self.info)
            bias = self._cast("bias")
        else:
            y = mesh.gather_from_model(
                F.conv2d(x, self._cast("weight"), padding=self.padding), 1, self.info)
            bias = None if self.bias is None else self._cast("bias")[:, None, None]
        return y if bias is None else y + bias

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor of this rank's slice's shape (the weight, its gradient,
        an Adam moment) gathered over the model group into the full
        layer's shape."""
        return mesh.gather_rows(x, self.info)

    def slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a tensor of the full layer's shape."""
        rows = self.weight.shape[0]
        if x.shape[1:] != self.weight.shape[1:] or x.shape[0] != rows * self.info.model_size:
            raise ValueError(f"a tensor of shape {tuple(x.shape)} is not the full weight of "
                             f"slices {tuple(self.weight.shape)} x {self.info.model_size}")
        return x[self.info.model_index * rows:(self.info.model_index + 1) * rows]

    def unsharded(self) -> nn.Module:
        """The plain layer with the gathered weight and a copy of the bias
        (a collective over the model group)."""
        weight = self.gather(self.weight)
        with torch.device("meta"):
            if self.padding is None:
                layer = Linear(weight.shape[1], weight.shape[0], self.compute_dtype)
            else:
                layer = Conv2d(weight.shape[1], weight.shape[0], weight.shape[2],
                               self.bias is not None, self.compute_dtype)
        layer.weight = nn.Parameter(weight if self.padding is None else weight.contiguous(
            memory_format=torch.channels_last))
        if self.bias is not None:
            layer.bias = nn.Parameter(self.bias.detach().clone())
        return layer


def tensor_parallel_layers(model: nn.Module, model_size: int, min_channels: int) -> list:
    """The names of the layers whose kernels the JAX package's
    ``param_shardings`` shards over a model axis of ``model_size``: every
    ``Conv2d`` or ``Linear`` (a Flax ``kernel`` with ``ndim >= 2``) with at
    least ``min_channels`` output channels, a multiple of ``model_size``;
    none when ``model_size`` is 1."""
    if model_size == 1:
        return []
    return [name for name, module in model.named_modules()
            if isinstance(module, (Conv2d, Linear))
            and module.weight.shape[0] >= min_channels
            and module.weight.shape[0] % model_size == 0]


def shard_model(model: nn.Module, info: mesh.MeshInfo, min_channels: int) -> list:
    """Replaces each of ``tensor_parallel_layers`` in ``model`` by its
    ``ColumnParallel`` slice for this rank, in place, and returns their
    names.  Every rank of the model group must hold the same full weights
    first.  With a model axis of one rank it changes nothing."""
    names = tensor_parallel_layers(model, info.model_size, min_channels)
    for name in names:
        parent, _, child = name.rpartition(".")
        owner = model.get_submodule(parent)
        setattr(owner, child, ColumnParallel(getattr(owner, child), info))
    return names


def sharded_layers(model: nn.Module) -> dict:
    """``{"<layer>.weight": layer}`` for every ``ColumnParallel`` layer in
    ``model``, in module order: the state-dict names of the sharded
    tensors."""
    return {f"{name}.weight": module for name, module in model.named_modules()
            if isinstance(module, ColumnParallel)}


def unsharded_copy(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with every ``ColumnParallel`` layer gathered
    into the plain full-width layer: every rank of the model group must
    call it (one gather per sharded layer).  ``model`` itself when nothing
    is sharded."""
    layers = list(sharded_layers(model).values())
    if not layers:
        return model
    # deepcopy takes what the memo holds for an object in place of a copy.
    return copy.deepcopy(model, {id(layer): layer.unsharded() for layer in layers})


class BatchNorm(nn.Module):
    """Affine BatchNorm over channels, eps 1e-5, with f32 statistics.

    In training mode (the module's ``training`` flag) it normalises with
    the batch statistics, computed as flax computes them: in f32, the
    variance as E[x^2] - E[x]^2 clipped at 0, over the global batch in a
    data-parallel step (the sums reduced over the ranks by
    ``parallel.mesh.all_reduce_sum``, as GSPMD reduces them over the
    devices), so every rank folds the same statistics.  It then folds the
    batch mean and the *biased* batch variance into the running statistics,
    ``0.9 * running + 0.1 * batch`` (torch's BatchNorm2d would fold the
    unbiased variance), unless ``update_statistics`` is off (see
    ``frozen_statistics``).  The normalisation runs in f32 and is cast to
    the input's dtype, as flax's ``_normalize`` promotes x against the f32
    statistics.

    In evaluation mode it uses the running statistics, and
    ``activation='leaky_relu'`` runs the pair as one launch of the fused
    epilogue kernel, which folds the raw statistics into a scale and shift
    and rounds them to the input's dtype exactly as the JAX path rounds
    them (``_FrozenBNLeakyRelu``).  Every BatchNorm of the model is
    affine, so the JAX block's ``affine=False`` is not ported.
    """

    def __init__(self, features: int, activation: Optional[str] = None):
        super().__init__()
        self.activation = activation
        self.update_statistics = True
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train_forward(x)
        if self.activation == "leaky_relu":
            return fused_batch_norm_leaky_relu(x, self.weight, self.bias, self.running_mean,
                                               self.running_var, EPS)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, EPS)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        axes = (0, 2, 3)
        # The sums of x and x^2 over the global batch (one collective, a
        # copy outside a data-parallel step), then the global count.
        sums = mesh.all_reduce_sum(torch.cat([xf.sum(dim=axes), (xf * xf).sum(dim=axes)]))
        mean, mean_square = (sums / (xf.numel() // xf.shape[1] * mesh.world_size())).chunk(2)
        var = torch.clamp(mean_square - mean * mean, min=0.0)
        if self.update_statistics:
            with torch.no_grad():
                self.running_mean.copy_(MOMENTUM * self.running_mean
                                        + (1 - MOMENTUM) * mean)
                self.running_var.copy_(MOMENTUM * self.running_var
                                       + (1 - MOMENTUM) * var)
        mul = torch.rsqrt(var + EPS) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        y = y.to(x.dtype)
        return leaky_relu(y) if self.activation == "leaky_relu" else y


@contextlib.contextmanager
def frozen_statistics(module: nn.Module) -> Iterator[None]:
    """Within the block, every training-mode ``BatchNorm`` under ``module``
    normalises with its batch statistics but leaves its running statistics
    as they are.  Activation checkpointing reruns a step's forward in the
    backward pass under this context, so the statistics are folded once
    per step, as in the JAX scan.  In a data-parallel step the rerun
    reduces its sums over the ranks again: every rank reruns the same
    steps in the same order, so the collectives pair up."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    previous = [m.update_statistics for m in norms]
    for m in norms:
        m.update_statistics = False
    try:
        yield
    finally:
        for m, flag in zip(norms, previous):
            m.update_statistics = flag


class ResidualBlock(nn.Module):
    """conv3x3 -> avgpool(d) -> BN -> lrelu -> conv3x3 -> BN (+ shortcut) -> add -> lrelu.

    Shortcut = conv1x1 -> avgpool(d) -> BN when the shape changes.  The JAX
    block's ``last_affine`` and ``drop_final_activation`` keep their
    defaults everywhere in the model and are not ported.
    """

    def __init__(self, in_planes: int, out_planes: int, downsample_factor: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.downsample_factor = downsample_factor
        self.conv1 = Conv2d(in_planes, out_planes, 3, False, dtype)
        self.bn1 = BatchNorm(out_planes, activation="leaky_relu")
        self.conv2 = Conv2d(out_planes, out_planes, 3, False, dtype)
        self.bn2 = BatchNorm(out_planes)
        self.has_shortcut = downsample_factor != 1 or in_planes != out_planes
        if self.has_shortcut:
            self.shortcut_conv = Conv2d(in_planes, out_planes, 1, False, dtype)
            self.shortcut_bn = BatchNorm(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1(avg_pool(self.conv1(x), self.downsample_factor))
        out = self.bn2(self.conv2(out))
        identity = x
        if self.has_shortcut:
            identity = self.shortcut_bn(
                avg_pool(self.shortcut_conv(x), self.downsample_factor))
        return leaky_relu(out + identity)


class SameBlock(nn.Module):
    """conv3x3 -> optional avgpool -> BN -> lrelu."""

    def __init__(self, in_planes: int, out_planes: int, downsample_factor: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.downsample_factor = downsample_factor
        self.conv1 = Conv2d(in_planes, out_planes, 3, False, dtype)
        self.bn1 = BatchNorm(out_planes, activation="leaky_relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn1(avg_pool(self.conv1(x), self.downsample_factor))


class UpBlock(nn.Module):
    """bilinear x2 -> conv3x3 -> BN -> lrelu; ``late_upscaling`` moves the
    interpolation after the activation.  Every UpBlock of the model is a
    bilinear x2 with a 3x3 kernel, so the JAX block's other modes are not
    ported."""

    def __init__(self, in_planes: int, out_planes: int, late_upscaling: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.late_upscaling = late_upscaling
        self.conv = Conv2d(in_planes, out_planes, 3, False, dtype)
        self.norm = BatchNorm(out_planes, activation="leaky_relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.late_upscaling:
            x = upsample_bilinear(x, 2)
        x = self.norm(self.conv(x))
        if self.late_upscaling:
            x = upsample_bilinear(x, 2)
        return x


class FinalBlock(nn.Module):
    """conv -> tanh, producing an image in [-1, 1]."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_planes, out_planes, kernel_size, True, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.conv(x))


def channelwise_concat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenates (B, C, H, W) tensors and (B, F) vectors along channels,
    broadcasting vectors over the spatial dims, into channels-last
    storage."""
    spatial = next((t for t in tensors if t.dim() == 4), None)
    if spatial is None:
        raise ValueError("At least one input must have spatial dimensions")
    height, width = spatial.shape[2], spatial.shape[3]
    return tops.cat([
        t if t.dim() == 4 else t[:, :, None, None].expand(-1, -1, height, width)
        for t in tensors], dim=1)


LSTMState = Tuple[torch.Tensor, torch.Tensor]


class ConvLSTMCell(nn.Module):
    """Convolutional LSTM cell: one fused 4C-channel 3x3 gate conv over
    ``cat([x, h])`` (gates in i, f, o, g order), then the fused gate kernel."""

    def __init__(self, in_planes: int, out_planes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gates = Conv2d(in_planes + out_planes, 4 * out_planes, 3, True, dtype)

    def forward(self, carry: LSTMState, x: torch.Tensor) -> Tuple[LSTMState, torch.Tensor]:
        h, c = carry
        new_h, new_c = fused_lstm_gates(self.gates(tops.cat([x, h], dim=1)), c)
        return (new_h, new_c), new_h


class ConvLSTM(nn.Module):
    """ConvLSTM with learnable (C, H, W) initial states."""

    def __init__(self, in_planes: int, out_planes: int, height: int, width: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.cell = ConvLSTMCell(in_planes, out_planes, dtype)
        self.initial_hidden_state = nn.Parameter(torch.zeros(out_planes, height, width))
        self.initial_cell_state = nn.Parameter(torch.zeros(out_planes, height, width))

    def init_carry(self, batch_size: int) -> LSTMState:
        """The initial states in the model dtype, repeated over the batch
        into channels-last tensors; differentiable, as the states are
        learned."""
        return tuple(s.to(self.dtype)[None].expand(batch_size, -1, -1, -1).contiguous(
            memory_format=torch.channels_last)
            for s in (self.initial_hidden_state, self.initial_cell_state))

    def forward(self, carry: LSTMState, x: torch.Tensor) -> Tuple[LSTMState, torch.Tensor]:
        return self.cell(carry, x)
