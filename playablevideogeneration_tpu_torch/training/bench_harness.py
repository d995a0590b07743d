"""Synthetic training workload: a config, a trainer and a batch at a given
shape, with seeded weights and data.

Counterpart of ``playablevideogeneration_tpu/training/bench_harness.py``,
for the chip check and, later, the port's bench.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from playablevideogeneration_tpu_torch.data import synthetic
from playablevideogeneration_tpu_torch.models.caddy import make_model
from playablevideogeneration_tpu_torch.training.trainer import Trainer
from playablevideogeneration_tpu_torch.utils.device import DeviceLike


class SyntheticBatch(NamedTuple):
    observations: np.ndarray  # (B, T, H, W, 3*stacking) f32, channels last
    actions: np.ndarray  # (B, T) int32


def make_synthetic_config(*, height: int, width: int, actions_count: int, batch_size: int,
                          observations_count: int, observation_stacking: int,
                          hidden_state_size: int, state_features: int,
                          pretraining_steps: int = 2, compute_dtype: str = "float32",
                          remat: bool = False, action_space_dimension: int = 2) -> dict:
    """``data.synthetic.make_synthetic_config`` (the JAX package's synthetic
    run config, in the reference YAML schema: BAIR's loss weights, learning
    rate and smooth MI, annealing over a few steps) with no data or output
    roots, and the compute dtype and per-step checkpointing in its ``tpu``
    block."""
    config = synthetic.make_synthetic_config(
        data_root="", output_root="", height=height, width=width, actions_count=actions_count,
        batch_size=batch_size, observations_count=observations_count,
        observation_stacking=observation_stacking, hidden_state_size=hidden_state_size,
        state_features=state_features, pretraining_steps=pretraining_steps,
        action_space_dimension=action_space_dimension)
    config["tpu"] = {"compute_dtype": compute_dtype, "remat": remat}
    return config


def build_synthetic_trainer(*, height: int, width: int, batch_size: int,
                            observations_count: int, actions_count: int = 7,
                            observation_stacking: int = 1, hidden_state_size: int = 128,
                            state_features: int = 64, compute_dtype: str = "bfloat16",
                            remat: bool = True, smooth_mi: bool = True,
                            pretraining_steps: int = 2, device: DeviceLike = "cuda",
                            seed: int = 0, backend: Optional[type] = None) -> Trainer:
    """A trainer over the synthetic config at the given workload shape,
    with the model (and the VGG) seeded from ``seed``, its state built.
    The defaults are the BAIR flagship's widths in bf16 with per-step
    activation checkpointing and smooth MI.  ``backend`` is the trainer's
    seam (``Trainer``)."""
    config = make_synthetic_config(
        height=height, width=width, actions_count=actions_count, batch_size=batch_size,
        observations_count=observations_count, observation_stacking=observation_stacking,
        hidden_state_size=hidden_state_size, state_features=state_features,
        pretraining_steps=pretraining_steps, compute_dtype=compute_dtype, remat=remat)
    model = make_model(config, device, seed)
    trainer = Trainer(config, model, smooth_mi=smooth_mi, seed=seed, backend=backend)
    trainer.init_state()
    return trainer


def make_synthetic_batch(*, batch_size: int, observations_count: int, height: int,
                         width: int, actions_count: int = 7, observation_stacking: int = 1,
                         seed: int = 0) -> SyntheticBatch:
    """Deterministic batch at the workload shape, channels last as the
    loader gives it: observations N(0, 0.1^2), actions uniform."""
    rng = np.random.default_rng(seed)
    shape = (batch_size, observations_count, height, width, 3 * observation_stacking)
    return SyntheticBatch(
        observations=rng.normal(size=shape).astype(np.float32) * 0.1,
        actions=rng.integers(0, actions_count,
                             size=(batch_size, observations_count)).astype(np.int32))
