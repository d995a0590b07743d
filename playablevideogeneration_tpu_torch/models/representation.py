"""Representation network E: observation -> (state, spatial attention).

Counterpart of ``playablevideogeneration_tpu/models/representation.py``:
conv3x3(->16) + avgpool2 + BN + lrelu, then six residual blocks
16->16->32->32->64->64->(state_features+1) with two x2 downsamples; the last
channel becomes a sigmoid spatial attention map, the rest the state.
Total spatial reduction x8.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from playablevideogeneration_tpu_torch.models.layers import (
    BatchNorm,
    ResidualBlock,
    avg_pool,
    Conv2d,
)


class RepresentationNetwork(nn.Module):
    def __init__(self, in_channels: int, state_features: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_channels, 16, 3, False, dtype)
        self.bn1 = BatchNorm(16, activation="leaky_relu")
        sf = state_features
        specs = [(16, 1), (32, 2), (32, 1), (sf, 2), (sf, 1), (sf + 1, 1)]
        planes_in = 16
        for i, (planes, down) in enumerate(specs):
            self.add_module(f"res{i}", ResidualBlock(planes_in, planes, down, dtype=dtype))
            planes_in = planes
        self.blocks = len(specs)

    def forward(self, observations: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """
        :param observations: (N, 3*observation_stacking, H, W), frames
            most-recent-first along channels
        :return: state (N, state_features, H/8, W/8),
                 attention (N, 1, H/8, W/8) in (0, 1)
        """
        x = self.bn1(avg_pool(self.conv1(observations), 2))
        for i in range(self.blocks):
            x = getattr(self, f"res{i}")(x)
        return x[:, :-1], torch.sigmoid(x[:, -1:])
