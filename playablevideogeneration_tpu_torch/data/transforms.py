"""Frame transforms: crop, resize, float array in [-1, 1] or [0, 1].

Counterpart of the training and evaluation transforms of
``playablevideogeneration_tpu/data/transforms.py``: an (H, W, 3) uint8
frame becomes an (H', W', 3) float32 array, in [-1, 1] for the model and
in [0, 1] for the offline evaluation's metrics.  The crop is array
slicing; a frame is resized only when its size differs from the target,
with Pillow's bilinear filter, as the JAX transform resizes it, so the two
give the same arrays.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def check_and_resize(target_crop: Optional[List[int]], target_size: Sequence[int]
                     ) -> Callable[[np.ndarray], np.ndarray]:
    """Crop [left, upper, right, lower], then bilinear resize to (width,
    height) when the size differs."""
    width, height = target_size

    def transform(frame: np.ndarray) -> np.ndarray:
        if target_crop is not None:
            left, upper, right, lower = target_crop
            if not (0 <= left < right <= frame.shape[1] and 0 <= upper < lower <= frame.shape[0]):
                raise ValueError(f"crop {target_crop} does not fit a frame of {frame.shape}")
            frame = frame[upper:lower, left:right]
        if frame.shape[:2] != (height, width):
            from PIL import Image

            frame = np.asarray(Image.fromarray(np.ascontiguousarray(frame)).resize(
                (width, height), Image.BILINEAR))
        return frame

    return transform


def make_train_transform(crop, target_size) -> Callable[[np.ndarray], np.ndarray]:
    """uint8 frame -> float32 in [-1, 1]."""
    resize = check_and_resize(crop, target_size)

    def transform(frame: np.ndarray) -> np.ndarray:
        return np.asarray(resize(frame), dtype=np.float32) / 255.0 * 2.0 - 1.0

    return transform


def make_evaluation_transform(crop, target_size) -> Callable[[np.ndarray], np.ndarray]:
    """uint8 frame -> float32 in [0, 1], the offline metrics' range."""
    resize = check_and_resize(crop, target_size)

    def transform(frame: np.ndarray) -> np.ndarray:
        return np.asarray(resize(frame), dtype=np.float32) / 255.0

    return transform


def get_final_transforms(config) -> Dict[str, Callable[[np.ndarray], np.ndarray]]:
    """The train, validation and test transforms of a run config."""
    t = make_train_transform(config["data"]["crop"],
                             config["model"]["representation_network"]["target_input_size"])
    return {"train": t, "validation": t, "test": t}


def get_evaluation_transforms(config) -> Tuple[Callable[[np.ndarray], np.ndarray],
                                               Callable[[np.ndarray], np.ndarray]]:
    """The (reference, generated) transforms of an evaluation config."""
    size = config["data"]["target_input_size"]
    return (make_evaluation_transform(config["reference_data"]["crop"], size),
            make_evaluation_transform(config["generated_data"]["crop"], size))
