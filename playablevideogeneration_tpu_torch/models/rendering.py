"""Rendering network D: hidden state -> multi-resolution frames.

Counterpart of ``playablevideogeneration_tpu/models/rendering.py``: three
bilinear x2 upsampling stages of widths (hidden, hidden/2, hidden/4) (x8 in
all, back to the input resolution); after each stage a conv+tanh FinalBlock
with kernel 3, 3, 7 emits an RGB frame.  Frames are returned high-res first.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from playablevideogeneration_tpu_torch.models.layers import (
    FinalBlock,
    ResidualBlock,
    UpBlock,
)

FINAL_KERNELS = (3, 3, 7)


class RenderingNetwork(nn.Module):
    def __init__(self, in_planes: int, widths: Tuple[int, int, int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stages = len(widths)
        for i, width in enumerate(widths):
            self.add_module(f"up{i}", UpBlock(in_planes, width, dtype=dtype))
            if i < self.stages - 1:
                self.add_module(f"res{i}", ResidualBlock(width, width, dtype=dtype))
            self.add_module(f"final{i}", FinalBlock(width, 3, FINAL_KERNELS[i], dtype))
            in_planes = width

    def forward(self, hidden_states: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """
        :param hidden_states: (N, hidden_state_size, h, w)
        :return: (N, 3, 8h, 8w) full-res frame, and the list
                 [(N, 3, 8h/2^i, 8w/2^i) for i in range(3)] high-res first,
                 all in [-1, 1]
        """
        x = hidden_states
        outputs = []
        for i in range(self.stages):
            x = getattr(self, f"up{i}")(x)
            if i < self.stages - 1:
                x = getattr(self, f"res{i}")(x)
            outputs.append(getattr(self, f"final{i}")(x))
        outputs.reverse()
        return outputs[0], outputs
