"""Small tensor reshaping helpers.

Counterpart of ``playablevideogeneration_tpu/utils/tensor_ops.py``.  Images
here are channels-first: (N, C, H, W), and sequences (B, T, C, H, W).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def flatten(x: torch.Tensor) -> torch.Tensor:
    """Merges the leading (batch, time) dimensions: (B, T, ...) -> (B*T, ...)."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


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
    as a contiguous f32 (B, T, C, H, W) tensor on ``device``."""
    x = torch.as_tensor(observations, device=device)
    return x.float().permute(0, 1, 4, 2, 3).contiguous()


def time_major(x: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) -> (T, B, ...)."""
    return x.transpose(0, 1)


def batch_major(x: torch.Tensor) -> torch.Tensor:
    """(T, B, ...) -> (B, T, ...)."""
    return x.transpose(0, 1)
