"""Smooth-MI trainer variant.

Counterpart of ``playablevideogeneration_tpu/training/smooth_mi.py``: the
MI loss runs on the EMA-smoothed joint matrix held in
``TrainState.mi_matrix``, which checkpoints save with the rest of the
state; nothing else differs from the base trainer.
"""
from __future__ import annotations

from playablevideogeneration_tpu_torch.models.caddy import Caddy
from playablevideogeneration_tpu_torch.training.trainer import Trainer
from playablevideogeneration_tpu_torch.utils.logging import Logger


def make_smooth_mi_trainer(config: dict, model: Caddy, dataset, logger: Logger,
                           **kwargs) -> Trainer:
    return Trainer(config, model, smooth_mi=True, dataset=dataset, logger=logger, **kwargs)
