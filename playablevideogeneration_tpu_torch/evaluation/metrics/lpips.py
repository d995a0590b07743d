"""LPIPS perceptual distance on a VGG backbone.

Counterpart of ``playablevideogeneration_tpu/evaluation/metrics/lpips.py``:
frames mapped from [0, 1] to [-1, 1] and through LPIPS's scaling layer,
VGG features at 5 levels normalised to unit length over channels, their
squared differences weighted by the linear heads (or averaged when there
are none), averaged over space and summed over the levels.  The heads
load from the same ``.npz`` that the JAX package reads (``lin0`` ...
``lin4``, one (C,) array each).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from playablevideogeneration_tpu_torch.evaluation.metrics.frame_metrics import frames_nchw
from playablevideogeneration_tpu_torch.models.vgg import Vgg19

# LPIPS's scaling layer.
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit length over the channels of (N, C, H, W) features."""
    norm = torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True))
    return x / (norm + eps)


def make_lpips_fn(vgg: Vgg19, linear_weights: Optional[List[np.ndarray]] = None
                  ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The distance of (B, T, H, W, 3) sequence pairs in [0, 1] -> (B, T).

    :param vgg: the 5-level feature extractor, on the device the distance
        runs on
    :param linear_weights: per level a (C,) array of head weights; None
        averages the squared differences over channels instead

    The returned function's ``vgg`` is its network, which a captured
    program of it watches for weight updates.
    """
    device = next(vgg.parameters()).device
    shift = torch.tensor(_SHIFT, device=device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=device).view(1, 3, 1, 1)
    heads = None if linear_weights is None else [
        torch.as_tensor(np.asarray(w, np.float32).reshape(-1), device=device).view(1, -1, 1, 1)
        for w in linear_weights]

    def features(x: torch.Tensor) -> List[torch.Tensor]:
        return vgg((2.0 * frames_nchw(x) - 1.0 - shift) / scale)

    def lpips(reference: torch.Tensor, generated: torch.Tensor) -> torch.Tensor:
        b, t = reference.shape[:2]
        total = 0.0
        for level, (a, bb) in enumerate(zip(features(reference), features(generated))):
            diff = (_normalize_tensor(a) - _normalize_tensor(bb)) ** 2
            if heads is not None:
                total = total + torch.sum(diff * heads[level], dim=1).mean(dim=(1, 2))
            else:
                total = total + diff.mean(dim=(1, 2, 3))
        return total.reshape(b, t)

    lpips.vgg = vgg
    return lpips


def load_lpips_linear_weights(path: str) -> List[np.ndarray]:
    """The heads of an ``.npz`` with keys ``lin0`` ... ``lin4``."""
    data = np.load(path)
    return [np.asarray(data[f"lin{i}"]).reshape(-1) for i in range(5)]
