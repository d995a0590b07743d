"""Small tensor reshaping helpers.

Counterpart of ``playablevideogeneration_tpu/utils/tensor_ops.py``.  Images
are indexed channels-first, (N, C, H, W), and sequences (B, T, C, H, W),
but stored channels-last: the channels are the innermost dimension in
memory (``torch.channels_last`` for an image), as the JAX package's NHWC
arrays and the H100's convolution kernels hold them.  Merging or splitting
the leading dimensions of such a sequence is a view.  ``cat`` and
``stack`` keep that storage where ``torch.cat`` and ``torch.stack`` would
fall back to channels-first.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def flatten(x: torch.Tensor) -> torch.Tensor:
    """Merges the leading (batch, time) dimensions: (B, T, ...) -> (B*T, ...).

    A sequence of images (B, T, C, H, W) is merged as (B, T, H, W, C): a
    view where the storage allows one, else a copy whose channels are
    innermost, where ``reshape`` would copy into channels-first."""
    if x.dim() != 5:
        return x.reshape((-1,) + tuple(x.shape[2:]))
    return x.movedim(2, -1).reshape((-1,) + tuple(x.shape[3:]) + (x.shape[2],)).movedim(-1, 1)


def fold(x: torch.Tensor, second_dim: int) -> torch.Tensor:
    """Splits the leading dimension: (B*T, ...) -> (B, T, ...) with T=second_dim."""
    first = x.shape[0]
    if first % second_dim != 0:
        raise ValueError(f"First dimension {first} is not a multiple of {second_dim}")
    return x.reshape((first // second_dim, second_dim) + tuple(x.shape[1:]))


def predecessor_successor_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Splits a (B, T, ...) tensor along time into (B, :T-1, ...), (B, 1:, ...)."""
    return x[:, :-1], x[:, 1:]


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear-resizes (..., C, H, W) images to (height, width).

    Matches ``jax.image.resize(method='linear')``, which the JAX package
    uses: half-pixel centres, and an antialiasing (triangle) filter that
    widens with the scale when the image shrinks.  Plain
    ``F.interpolate(mode='bilinear')`` samples 4 taps whatever the scale
    and differs when shrinking, hence ``antialias=True``, which is the
    same filter and equals the plain bilinear when enlarging.
    """
    lead = x.shape[:-3]
    flat = x.reshape((-1,) + tuple(x.shape[-3:]))
    out = F.interpolate(flat, size=(height, width), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.reshape(tuple(lead) + tuple(out.shape[1:]))


def sequence_to_nchw(observations, device) -> torch.Tensor:
    """The loader's channels-last (B, T, H, W, C) frames, numpy or tensor,
    as an f32 (B, T, C, H, W) tensor on ``device``: a view of the
    channels-last storage, which nothing copies."""
    x = torch.as_tensor(observations, device=device)
    return x.float().permute(0, 1, 4, 2, 3)


def _channel_dim(dim: int, ndim: int) -> int:
    """Where dimension ``dim`` of (..., C, H, W) lies once the channels
    are moved last, (..., H, W, C)."""
    dim %= ndim
    return {ndim - 3: ndim - 1, ndim - 2: ndim - 3, ndim - 1: ndim - 2}.get(dim, dim)


def cat(tensors: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """``torch.cat`` of (..., C, H, W) tensors along ``dim``, stored
    channels-last.  ``torch.cat`` of images keeps channels-last only when
    every input is channels-last-contiguous, and of sequences never: here
    the tensors are joined as (..., H, W, C) views, so the result's
    channels are innermost whatever the inputs' strides."""
    ndim = tensors[0].dim()
    joined = torch.cat([t.movedim(-3, -1) for t in tensors], _channel_dim(dim, ndim))
    return joined.movedim(-1, -3)


def stack(tensors: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """``torch.stack`` of (..., C, H, W) tensors along a new ``dim`` before
    the channels, stored channels-last, so that ``flatten`` of the result
    is a view."""
    joined = torch.stack([t.movedim(-3, -1) for t in tensors], dim)
    return joined.movedim(-1, -3)


def time_major(x: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) -> (T, B, ...)."""
    return x.transpose(0, 1)


def batch_major(x: torch.Tensor) -> torch.Tensor:
    """(T, B, ...) -> (B, T, ...)."""
    return x.transpose(0, 1)
