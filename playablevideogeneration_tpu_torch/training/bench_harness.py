"""Synthetic training workload: a config, a trainer and a batch at a given
shape, with seeded weights and data.

Counterpart of ``playablevideogeneration_tpu/training/bench_harness.py``
(and of the training part of ``data/synthetic.make_synthetic_config``),
for the chip check and, later, the port's bench.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

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
    """The training keys of the JAX package's synthetic run config
    (``data/synthetic.make_synthetic_config``), in the reference YAML
    schema: BAIR's loss weights, learning rate and smooth MI, annealing
    over a few steps."""
    loss_weights = {}
    for name, value in [("reconstruction_loss_lambda", 1.0), ("perceptual_loss_lambda", 1.0),
                        ("action_divergence_lambda", 0.0), ("states_rec_lambda", 0.2),
                        ("entropy_lambda", 0.0), ("action_directions_kl_lambda", 0.0001),
                        ("action_mutual_information_lambda", 0.15),
                        ("action_state_distribution_kl_lambda", 0.0)]:
        loss_weights[name] = loss_weights[f"{name}_pretraining"] = value
    loss_weights["hidden_states_rec_lambda_pretraining"] = 1.0
    return {
        "data": {"actions_count": actions_count},
        "model": {
            "representation_network": {"state_features": state_features,
                                       "state_resolution": [height // 8, width // 8]},
            "dynamics_network": {"hidden_state_size": hidden_state_size},
            "action_network": {"use_gumbel": True, "hard_gumbel": False, "ensamble_size": 1,
                               "action_space_dimension": action_space_dimension},
            "centroid_estimator": {"alpha": 0.1},
        },
        "training": {
            "trainer": "training.smooth_mi_trainer",
            "use_ground_truth_actions": False,
            "learning_rate": 0.0004,
            "weight_decay": 0.000001,
            "pretraining_steps": pretraining_steps,
            "pretraining_detach": False,
            "lr_schedule": [300000, 10000000000],
            "lr_gamma": 0.3333,
            "ground_truth_observations_start": 4,
            "ground_truth_observations_end": 2,
            "ground_truth_observations_steps": 4,
            "gumbel_temperature_start": 1.0,
            "gumbel_temperature_end": 0.4,
            "gumbel_temperature_steps": 4,
            "mutual_information_estimation_alpha": 0.2,
            "batching": {"batch_size": batch_size, "observations_count": observations_count,
                         "observations_count_start": observations_count,
                         "observations_count_steps": 10,
                         "observation_stacking": observation_stacking},
            "loss_weights": loss_weights,
        },
        "tpu": {"compute_dtype": compute_dtype, "remat": remat},
    }


def build_synthetic_trainer(*, height: int, width: int, batch_size: int,
                            observations_count: int, actions_count: int = 7,
                            observation_stacking: int = 1, hidden_state_size: int = 128,
                            state_features: int = 64, compute_dtype: str = "bfloat16",
                            remat: bool = True, smooth_mi: bool = True,
                            pretraining_steps: int = 2, device: DeviceLike = "cuda",
                            seed: int = 0) -> Trainer:
    """A trainer over the synthetic config at the given workload shape,
    with the model (and the VGG) seeded from ``seed``, its state built.
    The defaults are the BAIR flagship's widths in bf16 with per-step
    activation checkpointing and smooth MI."""
    config = make_synthetic_config(
        height=height, width=width, actions_count=actions_count, batch_size=batch_size,
        observations_count=observations_count, observation_stacking=observation_stacking,
        hidden_state_size=hidden_state_size, state_features=state_features,
        pretraining_steps=pretraining_steps, compute_dtype=compute_dtype, remat=remat)
    model = make_model(config, device, seed)
    trainer = Trainer(config, model, smooth_mi=smooth_mi, seed=seed)
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
