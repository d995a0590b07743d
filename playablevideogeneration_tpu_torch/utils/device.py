"""Device resolution for the port's entry points.

Counterpart of the platform choice in the JAX package's
``utils/jax_setup.py``.  Entry points default to ``"cuda"`` and never move
to the CPU on their own: without a GPU they raise unless the caller asks
for the CPU explicitly.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Returns ``torch.device(device)``; raises if it is a CUDA device and
    no GPU is visible."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return device
