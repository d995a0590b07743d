"""Structured model outputs.

Counterpart of ``playablevideogeneration_tpu/models/outputs.py``, with the
same field names.  B = batch, T = observations_count, A = actions_count,
D = action_space_dimension, (h, w) = state resolution.  Images are
channels-first, (B, T, C, H, W), where the JAX package keeps channels last.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch


@dataclass
class ModelOutput:
    # (B, T-1, 3, H, W) highest-resolution reconstructed observations
    reconstructed_observations: torch.Tensor
    # [(B, T-1, 3, H/2^i, W/2^i)], high-res first
    multiresolution_reconstructed_observations: List[torch.Tensor]
    # (B, T, state_features, h, w) states of the autoregressive/reconstructed sequence
    reconstructed_states: torch.Tensor
    # (B, T, state_features, h, w) states of the ground truth observations
    states: torch.Tensor
    # (B, T-1, hidden, h, w) dynamics-network hidden states
    hidden_states: torch.Tensor
    # (B, T-1) action indices selected by sampling
    selected_actions: torch.Tensor
    # (B, T-1, A)
    action_logits: torch.Tensor
    # (B, T-1, A) sampled action probability vectors
    action_samples: torch.Tensor
    # (B, T, 1, h, w) ground-truth attention maps
    attention: torch.Tensor
    # (B, T-1, 2, D) mean/variance of action directions
    action_directions_distribution: torch.Tensor
    # (B, T-1, D)
    sampled_action_directions: torch.Tensor
    # (B, T, 2, D) mean/variance of action states
    action_states_distribution: torch.Tensor
    # (B, T, D)
    sampled_action_states: torch.Tensor
    # (B, T-1, D) action variation vectors
    action_variations: torch.Tensor
    # (B, T-1, A) logits re-estimated on the reconstructed sequence
    reconstructed_action_logits: torch.Tensor
    # (B, T-1, 2, D)
    reconstructed_action_directions_distribution: torch.Tensor
    # (B, T-1, D)
    reconstructed_sampled_action_directions: torch.Tensor
    # (B, T, 2, D)
    reconstructed_action_states_distribution: torch.Tensor
    # (B, T, D)
    reconstructed_sampled_action_states: torch.Tensor
    # (B, T-1, 1, h, w) attention on the reconstructed sequence (full mode only)
    reconstructed_attention: Optional[torch.Tensor] = None
    # (B, T, hidden, h, w) hidden states decoded from GT states (pretraining only)
    reconstructed_hidden_states: Optional[torch.Tensor] = None
