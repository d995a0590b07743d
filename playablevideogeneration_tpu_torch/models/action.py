"""Action network A: state sequence -> discrete action posterior.

Counterpart of ``playablevideogeneration_tpu/models/action.py``.
Attention-weighted states -> two residual blocks (x2 channels, /2 spatial)
-> global average pool -> (mean, |variance|) per frame in the action space;
action directions are successor minus predecessor Gaussians (mean
difference, variance sum); reparameterised samples of the directions are
classified into ``actions_count`` logits.  The noise comes from an explicit
``torch.Generator``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from playablevideogeneration_tpu_torch.models.layers import Linear, ResidualBlock
from playablevideogeneration_tpu_torch.parallel import mesh
from playablevideogeneration_tpu_torch.utils import tensor_ops as tops


def reparameterized_sample(generator: torch.Generator, mean: torch.Tensor,
                           variance: torch.Tensor) -> torch.Tensor:
    """noise * sqrt(variance) + mean, noise ~ N(0, 1) drawn in f32 on the
    generator's device; in a data-parallel step this rank's rows of the
    global batch's draw (dim 0 is batch-major)."""
    noise = mesh.global_rows(
        lambda s: torch.randn(s, generator=generator, device=generator.device), mean.shape)
    return noise.to(device=mean.device, dtype=mean.dtype) * torch.sqrt(variance) + mean


class ActionNetwork(nn.Module):
    def __init__(self, state_features: int, actions_count: int,
                 action_space_dimension: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        sf = state_features
        self.res0 = ResidualBlock(sf, 2 * sf, downsample_factor=2, dtype=dtype)
        self.res1 = ResidualBlock(2 * sf, 2 * sf, downsample_factor=1, dtype=dtype)
        # The distribution heads run in f32 whatever the compute dtype: a
        # sharpened posterior's variance rounds to 0 in bf16 and the KL's
        # log then turns the step into NaN.
        self.mean_fc = Linear(2 * sf, action_space_dimension, torch.float32)
        self.variance_fc = Linear(2 * sf, action_space_dimension, torch.float32)
        self.final_fc = Linear(action_space_dimension, actions_count, dtype)

    def forward(self, generator: torch.Generator, states: torch.Tensor,
                states_attention: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """
        :param states: (B, T, state_features, h, w)
        :param states_attention: (B, T, 1, h, w)
        :return: action_logits (B, T-1, A),
                 action_directions_distribution (B, T-1, 2, D),
                 sampled_action_directions (B, T-1, D),
                 action_states_distribution (B, T, 2, D),
                 sampled_action_states (B, T, D)
        """
        observations_count = states.shape[1]
        x = tops.flatten(states * states_attention)
        x = self.res1(self.res0(x))
        x = x.mean(dim=(2, 3)).float()

        mean = self.mean_fc(x)
        variance = torch.abs(self.variance_fc(x))
        states_distribution = torch.stack([mean, variance], dim=1)
        sampled_states = reparameterized_sample(generator, mean, variance)

        pred_mean, succ_mean = tops.predecessor_successor_split(
            tops.fold(mean, observations_count))
        pred_var, succ_var = tops.predecessor_successor_split(
            tops.fold(variance, observations_count))
        directions_mean = succ_mean - pred_mean
        directions_variance = succ_var + pred_var
        directions_distribution = torch.stack([directions_mean, directions_variance], dim=2)
        sampled_directions = reparameterized_sample(
            generator, directions_mean, directions_variance)

        logits = self.final_fc(tops.flatten(sampled_directions))
        return (tops.fold(logits, observations_count - 1), directions_distribution,
                sampled_directions, tops.fold(states_distribution, observations_count),
                tops.fold(sampled_states, observations_count))
