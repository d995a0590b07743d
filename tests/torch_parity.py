"""Helpers shared by the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same numpy inputs and the same numpy weights; the
JAX package runs on the CPU backend, the port on ``device="cpu"``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def random_variables(tree: Mapping, seed: int) -> dict:
    """A numpy tree shaped like the JAX variables ``tree`` (arrays or
    ``ShapeDtypeStruct``s), filled from ``seed``: conv kernels
    LeCun-normal, BN scales in [0.5, 1.5], biases, BN means and initial
    LSTM states N(0, 0.1^2), BN variances in [0.5, 2], centroids N(0, 1).
    The statistics are far from (0, 1), so BatchNorm does real work."""
    rng = np.random.default_rng(seed)

    def fill(name, shape):
        if name == "kernel":
            return rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape)
        if name in ("bias", "mean") or name.startswith("initial_"):
            return rng.normal(size=shape) * 0.1
        if name == "centroids":
            return rng.normal(size=shape)
        raise KeyError(name)

    def walk(node):
        return {k: walk(v) if isinstance(v, Mapping)
                else fill(k, tuple(v.shape)).astype(np.float32)
                for k, v in sorted(node.items())}

    return walk(tree)


def nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> contiguous NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    """NCHW torch tensor -> NHWC numpy."""
    return x.detach().permute(0, 2, 3, 1).float().numpy()
