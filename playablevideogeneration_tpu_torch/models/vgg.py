"""VGG19 feature extractor for the perceptual loss.

Counterpart of ``playablevideogeneration_tpu/models/vgg.py``: VGG19's
convolutions up to relu5_1, emitting the 5 slices after relu1_1, relu2_1,
relu3_1, relu4_1 and relu5_1, frozen (its parameters take no gradient;
gradients still flow to its input).  Inputs are frames in [-1, 1], fed
unnormalised as the JAX package and the reference feed them.

The JAX package's ``grad_subpixel`` and ``fast_pool_grad`` are TPU
backward-pass layouts with the same forward, off by default; only the
plain conv and max-pool are ported.  The submodules carry the Flax names
(``conv0`` ... ``conv12``), so ``utils.jax_weights.load_jax_variables``
loads the JAX VGG tree ``{"params": {"conv0": ...}}`` as it is.  No
pretrained weights ship with the repository; ``make_vgg`` fills them from
a seed.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from playablevideogeneration_tpu_torch.models.caddy import seeded_init
from playablevideogeneration_tpu_torch.models.layers import Conv2d
from playablevideogeneration_tpu_torch.utils.device import DeviceLike, resolve_device

# (out_channels, max-pool before) of VGG19's convolutions up to conv5_1.
_VGG19_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False), (256, False),
    (512, True), (512, False), (512, False), (512, False),
    (512, True),
]
# Convolutions after whose ReLU a slice is taken: relu1_1, relu2_1,
# relu3_1, relu4_1, relu5_1.
_SLICE_AFTER = (0, 2, 4, 8, 12)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool, stride 2, flooring; a map smaller than 2 pixels pools
    to an empty one, as flax's VALID pooling does."""
    n, c, h, w = x.shape
    if h < 2 or w < 2:
        return x.new_zeros((n, c, h // 2, w // 2))
    return F.max_pool2d(x, 2)


class Vgg19(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        in_planes = 3
        for i, (channels, _) in enumerate(_VGG19_PLAN):
            self.add_module(f"conv{i}", Conv2d(in_planes, channels, 3, True, dtype))
            in_planes = channels
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(N, 3, H, W) -> the 5 feature maps (N, C_l, H_l, W_l).  Maps that
        pool to no pixels are empty, and so are all deeper ones."""
        outputs = []
        for i, (channels, pool_before) in enumerate(_VGG19_PLAN):
            if pool_before:
                x = _max_pool(x)
            conv = getattr(self, f"conv{i}")
            x = (F.relu(conv(x)) if x.shape[2] and x.shape[3]
                 else x.new_zeros((x.shape[0], channels) + tuple(x.shape[2:])))
            if i in _SLICE_AFTER:
                outputs.append(x)
        return outputs


def make_vgg(device: DeviceLike = "cuda", dtype: torch.dtype = torch.float32,
             seed: int = 0) -> Vgg19:
    """The frozen VGG19 with seeded weights (``caddy.seeded_init``) on
    ``device``, computing in ``dtype``."""
    return seeded_init(Vgg19(dtype), seed).to(resolve_device(device)).eval()
