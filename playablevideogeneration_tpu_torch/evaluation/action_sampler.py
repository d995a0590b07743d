"""Action and variation samplers plugged into the model's forward.

Counterpart of ``playablevideogeneration_tpu/evaluation/action_sampler.py``,
on tensors: the ``ActionSampler`` and ``VariationSampler`` contracts of
``models/caddy.py``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from playablevideogeneration_tpu_torch.utils.device import DeviceLike


def one_hot_action_sampler(log_probabilities: torch.Tensor,
                           ground_truth: torch.Tensor) -> torch.Tensor:
    """One-hot of the most likely action (the first, on ties)."""
    indexes = torch.argmax(log_probabilities, dim=-1)
    return F.one_hot(indexes, log_probabilities.shape[-1]).to(log_probabilities.dtype)


def make_ground_truth_action_sampler(ground_truth_to_actions_mapping: Dict[int, int],
                                     device: DeviceLike = "cpu"):
    """One-hot of each ground-truth action mapped through the Hungarian
    mapping (an unmapped action maps to itself, indices clamped to the
    table).  The table is made on ``device``, the model's, once: a captured
    forward cannot copy it from the host."""
    size = max(ground_truth_to_actions_mapping.keys()) + 1
    table = torch.tensor([ground_truth_to_actions_mapping.get(i, i) for i in range(size)],
                         device=device)

    def sampler(log_probabilities: torch.Tensor, ground_truth: torch.Tensor) -> torch.Tensor:
        lookup = table.to(ground_truth.device)  # no copy on the table's device
        translated = lookup[ground_truth.long().clamp(0, size - 1)]
        return F.one_hot(translated, log_probabilities.shape[-1]).to(log_probabilities.dtype)

    sampler.table = table
    return sampler


def zero_action_variation_sampler(sampled_action_directions: torch.Tensor,
                                  action_samples: torch.Tensor) -> torch.Tensor:
    """Zero variation vectors."""
    return sampled_action_directions * 0.0
