"""Weights drawn from ``--seed`` on the device, one state dict per model.

The benchmark's own initializer, after the rules of the port's
``caddy.seeded_init``: convolution and dense kernels LeCun-normal,
BatchNorm scales in [0.5, 1.5], biases, BatchNorm means and the ConvLSTMs'
initial states N(0, 0.1^2), BatchNorm variances in [0.5, 2] (the
statistics far from (0, 1), so the normalisation does real work),
centroids N(0, 1).  All normal draws are one call and all uniform draws
another, on the device's generator; the same state dict is loaded into the
port and into the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
from torch import nn


def _rule(name: str, shape) -> tuple:
    """(draw, low or mean, high or std) of a tensor."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and len(shape) in (2, 4):
        return "normal", 0.0, math.prod(shape[1:]) ** -0.5
    if leaf == "weight":
        return "uniform", 0.5, 1.5
    if leaf in ("bias", "running_mean") or leaf.startswith("initial_"):
        return "normal", 0.0, 0.1
    if leaf == "running_var":
        return "uniform", 0.5, 2.0
    if leaf == "centroids":
        return "normal", 0.0, 1.0
    raise ValueError(f"no seeded rule for {name}")


def seeded_state_dicts(models: Sequence[nn.Module], seed: int, device
                       ) -> List[Dict[str, torch.Tensor]]:
    """One state dict of float32 tensors on ``device`` per model (each
    model's own tensors may live on the meta device), drawn from ``seed``."""
    entries = []
    for model in models:
        for name, tensor in list(model.named_parameters()) + list(model.named_buffers()):
            entries.append((len(entries), name, tuple(tensor.shape)) + _rule(name, tensor.shape))
    generator = torch.Generator(device=device).manual_seed(seed)
    pools = {}
    for draw, fn in (("normal", torch.randn), ("uniform", torch.rand)):
        total = sum(math.prod(e[2]) for e in entries if e[3] == draw)
        pools[draw] = fn(total, generator=generator, device=device)
    offsets = {"normal": 0, "uniform": 0}
    dicts: List[Dict[str, torch.Tensor]] = []
    per_model = [len(list(m.named_parameters())) + len(list(m.named_buffers())) for m in models]
    flat = {}
    for index, name, shape, draw, a, b in entries:
        n = math.prod(shape)
        raw = pools[draw][offsets[draw]:offsets[draw] + n].view(shape)
        offsets[draw] += n
        flat[index] = (name, raw * b + a if draw == "normal" else raw * (b - a) + a)
    start = 0
    for count in per_model:
        dicts.append(dict(flat[i] for i in range(start, start + count)))
        start += count
    return dicts
