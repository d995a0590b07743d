"""Gumbel-softmax sampling.

Counterpart of ``playablevideogeneration_tpu/models/gumbel.py``.  The noise
comes from an explicit ``torch.Generator``, drawn on the generator's device
and moved to the logits' device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from playablevideogeneration_tpu_torch.parallel import mesh

_EPS = 1e-20


def gumbel_noise(generator: torch.Generator, shape, device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U + eps) + eps), U ~ U[0, 1), the
    reference's construction (gumbel_softmax.py:26-35), in f32; in a
    data-parallel step this rank's rows of the global batch's draw."""
    u = mesh.global_rows(
        lambda s: torch.rand(s, generator=generator, device=generator.device), shape)
    return (-torch.log(-torch.log(u + _EPS) + _EPS)).to(device)


def gumbel_softmax(log_probs: torch.Tensor, noise: torch.Tensor, temperature,
                   hard: bool = False) -> torch.Tensor:
    """softmax((log_probs + noise) / temperature) over the last axis; with
    ``hard`` the straight-through estimator: one-hot forward, soft
    gradient."""
    soft = F.softmax((log_probs + noise.to(log_probs.dtype)) / temperature, dim=-1)
    if hard:
        y_hard = F.one_hot(soft.argmax(dim=-1), soft.shape[-1]).to(soft.dtype)
        return soft + (y_hard - soft).detach()
    return soft


def gumbel_softmax_sample(generator: torch.Generator, log_probs: torch.Tensor,
                          temperature, hard: bool = False) -> torch.Tensor:
    """Samples from the Gumbel-softmax relaxation of ``log_probs`` (..., A);
    returns (..., A) vectors summing to 1."""
    noise = gumbel_noise(generator, log_probs.shape, log_probs.device)
    return gumbel_softmax(log_probs, noise, temperature, hard)
