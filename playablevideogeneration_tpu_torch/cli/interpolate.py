"""Action-interpolation rollouts.

Counterpart of ``playablevideogeneration_tpu/cli/interpolate.py``: for
each interpolation factor between two actions, a fixed-length sequence
from the same start observation, whose variation moves along the line
between the two actions' centroids; each is saved as a play session.
GPU by default, ``--device cpu`` when asked:

    python -m playablevideogeneration_tpu_torch.cli.interpolate \\
        --config configs/01_bair.yaml --first-action 0 --second-action 3
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from playablevideogeneration_tpu_torch.cli.play import load_play_session, save_session
from playablevideogeneration_tpu_torch.config.configuration import Configuration
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset
from playablevideogeneration_tpu_torch.utils.device import DeviceLike


def interpolate(config_dict: dict, first_action: int, second_action: int,
                factors: Optional[Sequence[float]] = None, frames_per_sequence: int = 10,
                device: DeviceLike = "cuda", dataset: Optional[VideoDataset] = None,
                save: bool = True) -> Dict[str, List[np.ndarray]]:
    """One sequence per factor (default 0.0, 0.1, ... 1.0), each saved
    (with ``save``) under the run's ``interpolated_sequences`` directory
    as ``interp_<first>_<second>_<factor>``, with the factor's selected
    action on every frame; returns ``{directory name: [frame (H, W, 3) in
    [-1, 1]] ...}``.  ``device`` and ``dataset`` are passed to
    ``load_play_session``."""
    if factors is None:
        factors = [i / 10.0 for i in range(11)]
    session, observation, logger = load_play_session(config_dict, device=device, dataset=dataset)
    output_dir = config_dict["logging"]["interpolated_sequences"]

    sequences = {}
    for factor in factors:
        session.start(observation)
        frames = [session.generate_next_interpolation(first_action, second_action, factor)
                  for _ in range(frames_per_sequence)]
        name = f"interp_{first_action}_{second_action}_{factor:.1f}"
        sequences[name] = frames
        if save:
            selected = second_action if factor > 0.5 else first_action
            save_session(frames, [selected] * len(frames), os.path.join(output_dir, name), logger)
    if save:
        logger.print(f"- Interpolations written to {output_dir}")
    return sequences


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--first-action", type=int, required=True)
    parser.add_argument("--second-action", type=int, required=True)
    parser.add_argument("--frames", type=int, default=10)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to play on (default: cuda)")
    args = parser.parse_args()

    configuration = Configuration(args.config)
    configuration.check_config()
    configuration.create_directory_structure()
    interpolate(configuration.get_config(), args.first_action, args.second_action,
                frames_per_sequence=args.frames, device=args.device)


if __name__ == "__main__":
    main()
