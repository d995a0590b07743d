"""Synthetic "moving square" videos and a run config over them.

Counterpart of ``playablevideogeneration_tpu/data/synthetic.py``: a
coloured square moves on a background under discrete actions (stay, left,
right, up, down), with the same seeded frames and actions as the JAX
generator.  Videos are built in memory (no Pillow) and written in the
reference's on-disk format by ``build_synthetic_dataset``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from playablevideogeneration_tpu_torch.data.video import Video

_ACTION_DELTAS = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]


def make_moving_square_video(length: int, height: int = 48, width: int = 48, square: int = 8,
                             actions_count: int = 3, seed: int = 0, step_pixels: int = 3,
                             fixed_y: Optional[int] = None) -> Video:
    """One video with per-frame ground-truth actions.  ``actions[t]`` is
    taken at frame t and moves the square into frame t+1, the convention
    the evaluator's accuracy labels assume.  ``fixed_y`` pins the square's
    row (breakout-style)."""
    rng = np.random.default_rng(seed)
    x = int(rng.integers(0, width - square))
    y = int(rng.integers(0, height - square)) if fixed_y is None else fixed_y
    frames, actions, rewards, metadata, dones = [], [], [], [], []
    for t in range(length):
        frame = np.full((height, width, 3), 32, dtype=np.uint8)
        frame[y:y + square, x:x + square] = (220, 60, 60)
        action = int(rng.integers(0, actions_count))
        frames.append(frame)
        actions.append(action)
        rewards.append(0.0)
        metadata.append({"state": [float(x), float(y)]})
        dones.append(t == length - 1)
        dx, dy = _ACTION_DELTAS[action % len(_ACTION_DELTAS)]
        x = int(np.clip(x + dx * step_pixels, 0, width - square))
        y = int(np.clip(y + dy * step_pixels, 0, height - square))
    return Video().add_content(frames, actions, rewards, metadata, dones)


def build_synthetic_dataset(root: str, videos_per_split: int = 3, length: int = 32,
                            height: int = 48, width: int = 48, actions_count: int = 3,
                            seed: int = 0, flat: bool = False, square: int = 8,
                            step_pixels: int = 3, fixed_y: Optional[int] = None) -> str:
    """Writes a splitted (train/ val/ test/) or flat synthetic dataset; the
    i-th video overall is seeded ``seed + i``."""
    splits = [""] if flat else ["train", "val", "test"]
    idx = 0
    for split in splits:
        split_dir = os.path.join(root, split) if split else root
        os.makedirs(split_dir, exist_ok=True)
        for _ in range(videos_per_split):
            video = make_moving_square_video(
                length=length, height=height, width=width, actions_count=actions_count,
                seed=seed + idx, square=square, step_pixels=step_pixels, fixed_y=fixed_y)
            video.save(os.path.join(split_dir, f"{idx:05d}"))
            idx += 1
    return root


def make_synthetic_config(data_root: str, output_root: str, height: int = 48, width: int = 48,
                          actions_count: int = 3, batch_size: int = 2,
                          observations_count: int = 5, observation_stacking: int = 2,
                          hidden_state_size: int = 16, state_features: int = 16,
                          pretraining_steps: int = 2, max_steps: int = 6,
                          action_space_dimension: int = 2) -> dict:
    """A complete run config for the synthetic dataset in the reference
    YAML schema, equal to the JAX package's for the same arguments: BAIR's
    loss weights, learning rate and smooth MI, annealing over a few steps."""
    loss_weights = {}
    for name, value in [("reconstruction_loss_lambda", 1.0), ("perceptual_loss_lambda", 1.0),
                        ("action_divergence_lambda", 0.0), ("states_rec_lambda", 0.2),
                        ("entropy_lambda", 0.0), ("action_directions_kl_lambda", 0.0001),
                        ("action_mutual_information_lambda", 0.15),
                        ("action_state_distribution_kl_lambda", 0.0)]:
        loss_weights[name] = loss_weights[f"{name}_pretraining"] = value
    loss_weights["hidden_states_rec_lambda_pretraining"] = 1.0
    return {
        "logging": {
            "run_name": "synthetic",
            "output_root": os.path.join(output_root, "results"),
            "save_root": os.path.join(output_root, "checkpoints"),
        },
        "data": {
            "data_root": data_root,
            "crop": None,
            "actions_count": actions_count,
            "ground_truth_available": True,
        },
        "model": {
            "architecture": "model.reduced_model.model",
            "representation_network": {
                "target_input_size": [width, height],
                "state_features": state_features,
                "state_resolution": [height // 8, width // 8],
            },
            "dynamics_network": {
                "hidden_state_size": hidden_state_size,
                "embedding_mlp_size": 16,
                "random_noise_size": 4,
            },
            "rendering_network": {"input_shape": [hidden_state_size, height // 8, width // 8]},
            "action_network": {
                "use_gumbel": True,
                "hard_gumbel": False,
                "ensamble_size": 1,
                "gumbel_temperature": 1.0,
                # 1 for 1-D motion (breakout), 2 for 2-D motion (tennis).
                "action_space_dimension": action_space_dimension,
            },
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
            "max_steps": max_steps,
            "save_freq": 1000,
            "ground_truth_observations_start": 4,
            "ground_truth_observations_end": 2,
            "ground_truth_observations_steps": 4,
            "gumbel_temperature_start": 1.0,
            "gumbel_temperature_end": 0.4,
            "gumbel_temperature_steps": 4,
            "mutual_information_estimation_alpha": 0.2,
            "batching": {
                "batch_size": batch_size,
                "observations_count": observations_count,
                "observations_count_start": observations_count,
                "observations_count_steps": 10,
                "skip_frames": 0,
                "observation_stacking": observation_stacking,
                "num_workers": 1,
            },
            "loss_weights": loss_weights,
            "action_direction_plotting_freq": 1000000,
        },
        "evaluation": {
            "evaluator": "evaluation.evaluator",
            "max_evaluation_batches": 2,
            "eval_freq": 1000000,
            "batching": {
                "batch_size": 2,
                "observations_count": 6,
                "skip_frames": 0,
                "observation_stacking": observation_stacking,
                "num_workers": 1,
            },
        },
        "evaluation_dataset": {
            "ground_truth_observations_init": 2,
            "builder": "evaluation.evaluation_dataset_builder",
        },
    }
