"""I3D (Inflated Inception-V1, Kinetics-400): the FVD's video embeddings,
NCDHW.

Counterpart of ``playablevideogeneration_tpu/evaluation/metrics/i3d.py``:
the kinetics-i3d graph up to its averaged 400 logits, the tensor that the
reference's FVD embeds.  Videos in [0, 1] are resized frame by frame to
224x224 as ``jax.image.resize(..., "linear")`` resizes them (BAIR's 256x256
frames shrink, so the antialiasing of ``utils.tensor_ops.resize_bilinear``
matters) and scaled to [-1, 1].

Convolutions and max pools pad as TensorFlow's ``SAME``: a total of
max((ceil(n / s) - 1) * s + k - n, 0), its smaller half in front, so a
stride-2 layer pads unevenly; the pools pad with -inf.  The submodules
carry the Flax names, so ``utils.jax_weights.load_jax_variables`` loads
the ``i3d.npz`` that ``tools/convert_weights.py`` writes (3-D kernels
``(kd, kh, kw, in, out)``).  Everything runs in f32 without gradients;
on a CUDA device the embedder replays a captured graph per input shape.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from playablevideogeneration_tpu_torch.evaluation.metrics.inception import FrozenBatchNorm
from playablevideogeneration_tpu_torch.inference import graphs
from playablevideogeneration_tpu_torch.utils.device import DeviceLike
from playablevideogeneration_tpu_torch.utils.jax_weights import (
    build_from_jax_variables,
    seeded_jax_variables,
)
from playablevideogeneration_tpu_torch.utils.tensor_ops import resize_bilinear

LOGITS = 400
Triple = Tuple[int, int, int]


def same_padding(x: torch.Tensor, kernel: Sequence[int], strides: Sequence[int],
                 value: float = 0.0) -> torch.Tensor:
    """Pads the (D, H, W) of an (N, C, D, H, W) tensor as TensorFlow's
    ``SAME`` does for ``kernel`` and ``strides``."""
    pads = []
    for n, k, s in zip(reversed(x.shape[2:]), reversed(kernel), reversed(strides)):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]  # F.pad takes the last dim first
    return F.pad(x, pads, value=value) if any(pads) else x


def max_pool_same(x: torch.Tensor, window: Triple, strides: Triple) -> torch.Tensor:
    return F.max_pool3d(same_padding(x, window, strides, -math.inf), window, strides)


class Unit3D(nn.Module):
    """``SAME`` conv3d without bias, then BatchNorm (eps 1e-3, a shift but
    no scale), then ReLU."""

    def __init__(self, in_planes: int, features: int, kernel: Triple = (1, 1, 1),
                 strides: Triple = (1, 1, 1)):
        super().__init__()
        self.kernel, self.strides = kernel, strides
        self.conv3d = nn.Conv3d(in_planes, features, kernel, strides, bias=False)
        self.bn = FrozenBatchNorm(features, scale=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv3d(same_padding(x, self.kernel, self.strides))))


class InceptionModule(nn.Module):
    """1x1; 1x1 -> 3x3x3; 1x1 -> 3x3x3; 3x3x3 max pool -> 1x1."""

    def __init__(self, in_planes: int, b0: int, b1a: int, b1b: int, b2a: int, b2b: int,
                 b3b: int):
        super().__init__()
        self.Branch_0 = Unit3D(in_planes, b0)
        self.Branch_1a = Unit3D(in_planes, b1a)
        self.Branch_1b = Unit3D(b1a, b1b, (3, 3, 3))
        self.Branch_2a = Unit3D(in_planes, b2a)
        self.Branch_2b = Unit3D(b2a, b2b, (3, 3, 3))
        self.Branch_3b = Unit3D(in_planes, b3b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.Branch_0(x), self.Branch_1b(self.Branch_1a(x)),
                          self.Branch_2b(self.Branch_2a(x)),
                          self.Branch_3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))], dim=1)


# (name, input channels, branch widths) of the inception blocks, in order.
_MIXED = [
    ("Mixed_3b", 192, (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", 256, (128, 128, 192, 32, 96, 64)),
    ("Mixed_4b", 480, (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", 512, (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", 512, (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", 512, (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", 528, (256, 160, 320, 32, 128, 128)),
    ("Mixed_5b", 832, (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", 832, (384, 192, 384, 48, 128, 128)),
]
# The max pools before a block: (window, strides).
_POOL_BEFORE = {"Mixed_4b": ((3, 3, 3), (2, 2, 2)), "Mixed_5b": ((2, 2, 2), (2, 2, 2))}


class I3D(nn.Module):
    """(N, T, 3, H, W) videos in [0, 1] -> (N, 400) averaged logits.

    ``input_size`` stays 224 for FVD; smaller sizes are for tests.  The
    ``Mixed_*`` blocks are children in forward order, so hooks on them
    give every block's output.
    """

    def __init__(self, input_size: int = 224):
        super().__init__()
        self.input_size = input_size
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        for name, in_planes, widths in _MIXED:
            self.add_module(name, InceptionModule(in_planes, *widths))
        self.Logits_Conv3d_0c_1x1 = nn.Conv3d(1024, LOGITS, 1)
        self.requires_grad_(False)

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(videos, self.input_size, self.input_size)
        x = (2.0 * x - 1.0).transpose(1, 2)  # (N, 3, T, s, s)
        x = max_pool_same(self.Conv3d_1a_7x7(x), (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        for name, _, _ in _MIXED:
            if name in _POOL_BEFORE:
                x = max_pool_same(x, *_POOL_BEFORE[name])
            x = getattr(self, name)(x)
        # The logits head: a VALID average pool over min(2, T') frames and
        # the whole map (kinetics-i3d's (2, 7, 7) window at 224), a 1x1x1
        # convolution with bias, and the mean over what is left.
        x = F.avg_pool3d(x, (min(2, x.shape[2]),) + tuple(x.shape[3:]), 1)
        return self.Logits_Conv3d_0c_1x1(x).mean(dim=(2, 3, 4))


def make_i3d(variables: Dict, device: DeviceLike = "cuda") -> I3D:
    """The FVD backbone on ``device`` with the converted variables."""
    return build_from_jax_variables(I3D, variables, device)


def make_fvd_embedder(variables: Dict, device: DeviceLike = "cuda",
                      backend: Optional[type] = None) -> Callable[[np.ndarray], np.ndarray]:
    """(N, T, H, W, 3) videos in [0, 1] -> (N, 400) numpy embeddings,
    computed on ``device`` and read back once per call: on a CUDA device
    the replay of a captured graph per (N, T, H, W, TF32 switches), as the
    JAX package's ``jax.jit`` traces per shape (``graphs.replayed``; its
    ``backend`` seam for the tests and the chip check).  The backbone is
    the returned function's ``model``."""
    model = make_i3d(variables, device)

    @torch.no_grad()
    def embeddings(x: torch.Tensor) -> torch.Tensor:
        return model(x.permute(0, 1, 4, 2, 3))

    forward = graphs.replayed(embeddings, model, next(model.parameters()).device, backend)

    def embed(videos) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(videos, np.float32)))
        return graphs.to_numpy(forward(x))

    embed.model, embed.programs = model, forward.programs
    return embed


def random_i3d_variables(seed: int) -> Dict:
    """Seeded variables in the converted file's layout (flax names, DHWIO
    kernels, numpy), the BatchNorm statistics away from (0, 1)."""
    with torch.device("meta"):
        model = I3D()
    return seeded_jax_variables(model, seed)
