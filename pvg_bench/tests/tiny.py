"""Tiny cells for the CPU tests: the benchmark's configurations and mixes
cut to frames of 32 x 32 (Tennis 32 x 64), hidden 16, 8 state features,
batch 2 of 4 frames, short requests, computing in float32 or bfloat16."""
from __future__ import annotations

import copy

import torch

from pvg_bench import drive, spec

# workload -> (config, traffic)
CELLS = {"bair.train": ("bair", "train_loop"), "tennis.train": ("tennis", "train_loop"),
         "bair.play": ("bair", "play_interactive"), "bair.rollout": ("bair", "play_rollout")}
SEED = 2 ** 31 + 12345  # above 32 signed bits, as the driver's seeds are


def tiny_config(name: str, bf16: bool = False) -> dict:
    config = copy.deepcopy(spec.program_config(name))
    height, width = (32, 64) if name == "tennis" else (32, 32)
    config["model"]["representation_network"].update(
        target_input_size=[width, height], state_features=8,
        state_resolution=[height // 8, width // 8])
    config["model"]["dynamics_network"]["hidden_state_size"] = 16
    config["data"]["crop"] = [0, 0, width, height]
    config["training"]["batching"].update(batch_size=2, observations_count=4,
                                          observations_count_start=3, num_workers=2)
    if not bf16:
        config["tpu"].pop("compute_dtype")
    return config


def tiny_traffic(name: str) -> dict:
    traffic = spec.traffic(name)
    traffic.update({k: v for k, v in dict(videos=4, samples_per_video=4, segment_frames=12,
                                          rollout_frames=6, check_requests=2,
                                          check_share=1.0).items() if k in traffic})
    return traffic


def tiny_cell(workload: str, seed: int = SEED, bf16: bool = False, trace: bool = False,
              seconds: float = 0.5) -> drive.Cell:
    config, traffic = CELLS[workload]
    return drive.Cell(workload=workload, config=tiny_config(config, bf16),
                      traffic=tiny_traffic(traffic), limits=spec.limits(workload), seed=seed,
                      seconds=seconds, trace=trace, device=torch.device("cpu"))
