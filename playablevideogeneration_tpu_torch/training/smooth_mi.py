"""Smooth-MI trainer variant.

Counterpart of ``playablevideogeneration_tpu/training/smooth_mi.py``: the
MI loss runs on the EMA-smoothed joint matrix held in
``TrainState.mi_matrix``; nothing else differs from the base trainer.
"""
from __future__ import annotations

from playablevideogeneration_tpu_torch.models.caddy import Caddy
from playablevideogeneration_tpu_torch.training.trainer import Trainer


def make_smooth_mi_trainer(config: dict, model: Caddy, **kwargs) -> Trainer:
    return Trainer(config, model, smooth_mi=True, **kwargs)
