"""InceptionV3 (FID variant): the FID's pool3 features and the Inception
Score's class probabilities, NCHW.

Counterpart of ``playablevideogeneration_tpu/evaluation/metrics/inception.py``:
torchvision's InceptionV3 with pytorch_fid's pooling changes (3x3 average
pools that do not count the padding in the A, C and first E blocks, a
3x3 max pool in the last E block), giving 2048 pool3 features per frame.
Frames in [0, 1] are resized to 299x299 as ``jax.image.resize(..., "linear")``
resizes them (``utils.tensor_ops.resize_bilinear``) and scaled to [-1, 1].

The submodules carry the Flax names (``Mixed_5b.branch1x1.conv`` ...), so
``utils.jax_weights.load_jax_variables`` loads the ``fid_inception.npz``
that ``tools/convert_weights.py`` writes.  The converted file keeps the
1008-way classifier head ``fc`` for the Inception Score; FID ignores it.
Everything runs in f32 without gradients; on a CUDA device the extractor
and the classifier replay a captured graph per input shape.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from playablevideogeneration_tpu_torch.inference import graphs
from playablevideogeneration_tpu_torch.utils.device import DeviceLike
from playablevideogeneration_tpu_torch.utils.jax_weights import (
    build_from_jax_variables,
    seeded_jax_variables,
)
from playablevideogeneration_tpu_torch.utils.tensor_ops import resize_bilinear

FEATURES = 2048
# The classifier head of the TF-ported checkpoint that pytorch_fid loads.
FC_CLASSES = 1008


class FrozenBatchNorm(nn.Module):
    """BatchNorm over dim 1 with its running statistics: eps 1e-3, and a
    scale only when ``scale`` (I3D's has none)."""

    def __init__(self, features: int, scale: bool = True, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features)) if scale else None
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class BasicConv(nn.Module):
    """Conv without bias, then BatchNorm (eps 1e-3, affine), then ReLU."""

    def __init__(self, in_planes: int, features: int, kernel, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_planes, features, kernel, stride, padding, bias=False)
        self.bn = FrozenBatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3_no_pad_count(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool whose border windows average only the
    pixels they cover (pytorch_fid's FID blocks)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool without padding."""
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, in_planes: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(in_planes, 64, 1)
        self.branch5x5_1 = BasicConv(in_planes, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(in_planes, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(in_planes, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_no_pad_count(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_planes: int):
        super().__init__()
        self.branch3x3 = BasicConv(in_planes, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(in_planes, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_planes: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv(in_planes, 192, 1)
        self.branch7x7_1 = BasicConv(in_planes, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(in_planes, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(in_planes, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3_no_pad_count(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_planes: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(in_planes, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(in_planes, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    """``use_max_pool``: the last block (pytorch_fid's FIDInceptionE_2)
    pools its branch with a 3x3 stride-1 max pool, padded by 1."""

    def __init__(self, in_planes: int, use_max_pool: bool = False):
        super().__init__()
        self.use_max_pool = use_max_pool
        self.branch1x1 = BasicConv(in_planes, 320, 1)
        self.branch3x3_1 = BasicConv(in_planes, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(in_planes, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(in_planes, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        pooled = (F.max_pool2d(x, 3, 1, 1) if self.use_max_pool
                  else _avg_pool_3x3_no_pad_count(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], dim=1)


class InceptionV3FID(nn.Module):
    """(N, 3, H, W) frames in [0, 1] -> (N, 2048) pool3 features.

    ``input_size`` stays 299 for FID; smaller sizes are for tests.  The
    ``Mixed_*`` blocks are children in forward order, so hooks on them
    give every block's output.
    """

    def __init__(self, input_size: int = 299):
        super().__init__()
        self.input_size = input_size
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, use_max_pool=True)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = 2.0 * resize_bilinear(x, self.input_size, self.input_size) - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x.mean(dim=(2, 3))


def _split_head(variables: Dict) -> Tuple[Dict, Optional[Dict]]:
    """(the backbone's variables, the ``fc`` head's params or None)."""
    params = dict(variables["params"])
    head = params.pop("fc", None)
    return {"params": params, "batch_stats": variables["batch_stats"]}, head


def make_inception(variables: Dict, device: DeviceLike = "cuda") -> InceptionV3FID:
    """The FID backbone on ``device`` with the converted variables (an
    ``fc`` head among them is left out)."""
    return build_from_jax_variables(InceptionV3FID, _split_head(variables)[0], device)


def _on_host(frames) -> torch.Tensor:
    """(N, H, W, 3) numpy frames as an f32 CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(frames, np.float32)))


def make_fid_extractor(variables: Dict, device: DeviceLike = "cuda",
                       backend: Optional[type] = None) -> Callable[[np.ndarray], np.ndarray]:
    """(N, H, W, 3) frames in [0, 1] -> (N, 2048) numpy features, computed
    on ``device`` and read back once per call: on a CUDA device the replay
    of a captured graph per (N, H, W, TF32 switches), as the JAX
    package's ``jax.jit`` traces per shape (``graphs.replayed``; its
    ``backend`` seam for the tests and the chip check).  The backbone is
    the returned function's ``model``."""
    model = make_inception(variables, device)

    @torch.no_grad()
    def features(x: torch.Tensor) -> torch.Tensor:
        return model(x.permute(0, 3, 1, 2))

    forward = graphs.replayed(features, model, next(model.parameters()).device, backend)

    def extract(frames) -> np.ndarray:
        return graphs.to_numpy(forward(_on_host(frames)))

    extract.model, extract.programs = model, forward.programs
    return extract


def random_inception_variables(seed: int, with_fc: bool = True) -> Dict:
    """Seeded variables in the converted file's layout (flax names, HWIO
    kernels, numpy), the BatchNorm statistics away from (0, 1); with a
    1008-way ``fc`` head when ``with_fc``."""
    with torch.device("meta"):
        model = InceptionV3FID()
        if with_fc:
            model.fc = nn.Linear(FEATURES, FC_CLASSES)
    return seeded_jax_variables(model, seed)


# --------------------------------------------------------------------- #
# Inception Score                                                       #
# --------------------------------------------------------------------- #


def make_class_probability_fn(variables: Dict, device: DeviceLike = "cuda",
                              backend: Optional[type] = None
                              ) -> Callable[[np.ndarray], np.ndarray]:
    """(N, H, W, 3) frames in [0, 1] -> (N, classes) numpy softmax class
    probabilities: the pool3 features through the checkpoint's ``fc``
    head, replayed as ``make_fid_extractor``'s features are.  The backbone
    and the head are the returned function's ``model`` and ``head``."""
    backbone, fc = _split_head(variables)
    if fc is None:
        raise ValueError("Checkpoint has no classifier head ('fc') — "
                         "convert with tools/convert_weights.py fid-inception")
    model = build_from_jax_variables(InceptionV3FID, backbone, device)
    classes = np.shape(fc["bias"])[0]
    head = build_from_jax_variables(lambda: nn.Linear(FEATURES, classes), {"params": fc}, device)

    @torch.no_grad()
    def probabilities(x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(head(model(x.permute(0, 3, 1, 2))), dim=-1)

    forward = graphs.replayed(probabilities, nn.ModuleList([model, head]).eval(),
                              next(model.parameters()).device, backend)

    def probs(frames) -> np.ndarray:
        return graphs.to_numpy(forward(_on_host(frames)))

    probs.model, probs.head, probs.programs = model, head, forward.programs
    return probs


def inception_score(class_probabilities: np.ndarray, splits: int = 10) -> tuple:
    """exp(E_x KL(p(y|x) || p(y))) per split of the frames, as (mean, std)
    over the splits."""
    probs = np.asarray(class_probabilities, np.float64)
    n = probs.shape[0]
    scores = []
    for part in np.array_split(probs, min(splits, n)):
        marginal = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(marginal + 1e-12))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))
