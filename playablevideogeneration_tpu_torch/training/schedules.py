"""Annealing schedules and the optimizer.

Counterpart of ``playablevideogeneration_tpu/training/schedules.py``.  The
schedules are host-side functions of the global step.
"""
from __future__ import annotations

import math
from typing import Iterable, Tuple

import torch


def ground_truth_observations_count(step: int, start: int, end: int,
                                    anneal_steps: int) -> int:
    """ceil(linear anneal start -> end), floored at ``end``."""
    return max(end, math.ceil(start - (start - end) * step / anneal_steps))


def gumbel_temperature(step: int, start: float, end: float, anneal_steps: int) -> float:
    """Linear anneal start -> end, floored at ``end``."""
    return max(end, start - (start - end) * step / anneal_steps)


def observations_count(step: int, start: int, end: int, anneal_steps: int) -> int:
    """floor(linear anneal start -> end), capped at ``end``."""
    return min(end, math.floor(start + (end - start) * step / anneal_steps))


def make_optimizer(config: dict, parameters: Iterable[torch.nn.Parameter]
                   ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.MultiStepLR]:
    """Adam with L2 weight decay added to the gradient before the moments
    (``Adam(weight_decay=...)``, which the JAX package writes as optax's
    ``add_decayed_weights`` before ``scale_by_adam``), eps outside the
    square root, and ``MultiStepLR``.

    The scheduler is stepped once after each optimizer step, so update k
    (counting from 0) runs at ``lr * gamma ** (milestones <= k)``: optax's
    ``piecewise_constant_schedule`` indexed by its update count, which
    scales from the update whose count equals the boundary.
    """
    t = config["training"]
    optimizer = torch.optim.Adam(parameters, lr=t["learning_rate"], betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=t["weight_decay"])
    scheduler = torch.optim.lr_scheduler.MultiStepLR(
        optimizer, milestones=[int(m) for m in t["lr_schedule"]], gamma=t["lr_gamma"])
    return optimizer, scheduler
