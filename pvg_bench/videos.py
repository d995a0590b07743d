"""The benchmark's inputs: seeded moving-square videos held in memory.

The generator of the port's ``data/synthetic.py`` (a coloured square on a
dark background, moved by discrete actions: stay, left, right, up, down),
copied here so that the inputs do not move when the program does.  Each
video is seeded by ``(seed, index)``, so the benchmark and the reference
make the same frames from ``--seed`` alone.  Frames are (H, W, 3) uint8;
the card's machine has no Pillow, and none is needed.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

_ACTION_DELTAS = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]
BACKGROUND = 32
SQUARE_COLOUR = (220, 60, 60)


def moving_square(seed: int, index: int, frames: int, height: int, width: int,
                  actions_count: int) -> Tuple[np.ndarray, List[int]]:
    """Video ``index`` of ``seed``: (frames, H, W, 3) uint8 and its
    per-frame actions; ``actions[t]`` moves the square into frame t + 1.
    The square is an eighth of the height and moves a twentieth of it a
    step."""
    rng = np.random.default_rng([seed, index])
    square, step = max(height // 8, 1), max(height // 20, 1)
    x = int(rng.integers(0, width - square))
    y = int(rng.integers(0, height - square))
    actions = rng.integers(0, actions_count, frames).tolist()
    video = np.full((frames, height, width, 3), BACKGROUND, dtype=np.uint8)
    for t, action in enumerate(actions):
        video[t, y:y + square, x:x + square] = SQUARE_COLOUR
        dx, dy = _ACTION_DELTAS[action % len(_ACTION_DELTAS)]
        x = int(np.clip(x + dx * step, 0, width - square))
        y = int(np.clip(y + dy * step, 0, height - square))
    return video, actions


def frame_size(config: dict) -> Tuple[int, int]:
    """(height, width) of the config's frames (its crop is the whole
    frame, so the transform only rescales)."""
    width, height = config["model"]["representation_network"]["target_input_size"]
    return height, width


def to_model_range(frames: np.ndarray) -> np.ndarray:
    """uint8 frames -> float32 in [-1, 1], the train transform's
    arithmetic."""
    return np.asarray(frames, dtype=np.float32) / 255.0 * 2.0 - 1.0


def start_observation(config: dict, seed: int, index: int) -> np.ndarray:
    """The play cells' ``index``-th initial observation: frame 0 of a
    seeded video, stacked ``observation_stacking`` times (a sequence
    start repeats its first frame), (H, W, 3 * stacking) in [-1, 1]."""
    height, width = frame_size(config)
    video, _ = moving_square(seed, index, 1, height, width, config["data"]["actions_count"])
    stacking = config["training"]["batching"]["observation_stacking"]
    return np.concatenate([to_model_range(video[0])] * stacking, axis=-1)
