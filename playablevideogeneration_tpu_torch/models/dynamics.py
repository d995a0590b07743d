"""Recurrent dynamics network R: one step of the hourglass of ConvLSTMs.

Counterpart of ``playablevideogeneration_tpu/models/dynamics.py``: three
ConvLSTM+BatchNorm blocks interleaved with SameBlock(/2) -> UpBlock(bilinear,
late upscale) -> SameBlock, at state resolution /1 -> /2 -> /1.  The action
vector and the action-variation vector are broadcast spatially and
concatenated, in the order ``[x, actions, variations]``, at the input of
every block.  The recurrent state is an explicit ``DynamicsCarry``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from playablevideogeneration_tpu_torch.models.layers import (
    BatchNorm,
    ConvLSTM,
    LSTMState,
    SameBlock,
    UpBlock,
    channelwise_concat,
)

# ((h0, c0), (h1, c1), (h2, c2)) for the three ConvLSTM blocks, (B, C, H, W)
# stored channels-last
DynamicsCarry = Tuple[LSTMState, LSTMState, LSTMState]


class ConvDynamicsNetwork(nn.Module):
    def __init__(self, state_features: int, actions_count: int,
                 action_space_dimension: int, hidden_state_size: int,
                 state_resolution: Tuple[int, int], dtype: torch.dtype = torch.float32):
        super().__init__()
        h, w = state_resolution
        hs = hidden_state_size
        extra = actions_count + action_space_dimension
        self.lstm0 = ConvLSTM(state_features + extra, hs, h, w, dtype)
        self.bn0 = BatchNorm(hs)
        self.same0 = SameBlock(hs + extra, 2 * hs, downsample_factor=2, dtype=dtype)
        self.lstm1 = ConvLSTM(2 * hs + extra, 2 * hs, h // 2, w // 2, dtype)
        self.bn1 = BatchNorm(2 * hs)
        self.up0 = UpBlock(2 * hs + extra, hs, late_upscaling=True, dtype=dtype)
        self.lstm2 = ConvLSTM(hs + extra, hs, h, w, dtype)
        self.bn2 = BatchNorm(hs)
        self.same1 = SameBlock(hs + extra, hs, downsample_factor=1, dtype=dtype)

    def init_carry(self, batch_size: int) -> DynamicsCarry:
        """Learnable initial (h, c) per LSTM, repeated over the batch."""
        return (self.lstm0.init_carry(batch_size), self.lstm1.init_carry(batch_size),
                self.lstm2.init_carry(batch_size))

    def forward(self, carry: DynamicsCarry, states: torch.Tensor, actions: torch.Tensor,
                variations: torch.Tensor) -> Tuple[DynamicsCarry, torch.Tensor]:
        """One recurrent step.

        :param states: (B, state_features, h, w)
        :param actions: (B, actions_count) action probability vectors
        :param variations: (B, action_space_dimension)
        :return: (new_carry, hidden_state (B, hidden_state_size, h, w))
        """
        c0, c1, c2 = carry
        c0, x = self.lstm0(c0, channelwise_concat([states, actions, variations]))
        x = self.same0(channelwise_concat([self.bn0(x), actions, variations]))
        c1, x = self.lstm1(c1, channelwise_concat([x, actions, variations]))
        x = self.up0(channelwise_concat([self.bn1(x), actions, variations]))
        c2, x = self.lstm2(c2, channelwise_concat([x, actions, variations]))
        x = self.same1(channelwise_concat([self.bn2(x), actions, variations]))
        return (c0, c1, c2), x
