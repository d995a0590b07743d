"""A video: frames plus per-frame actions, rewards, metadata and dones.

Counterpart of ``playablevideogeneration_tpu/data/video.py``, in the
reference's on-disk format: a directory of zero-padded frame images
(``00000.png`` ...) and four pickles, ``actions.pkl``, ``rewards.pkl``,
``metadata.pkl`` and ``dones.pkl``.  Frames on disk load lazily, images
with transparency flattened onto white.

A frame is an (H, W, 3) uint8 array.  Pillow is imported only where a
frame file is read or written, so videos built in memory need no Pillow.
"""
from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np

_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp")


def pillow_image(purpose: str):
    """Pillow's ``Image`` module; raises an ImportError that names
    ``purpose`` when Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{purpose} needs Pillow, which is not installed") from e
    return Image


def read_frame(path: str) -> np.ndarray:
    """An image file as an (H, W, 3) uint8 array, transparency flattened
    onto white."""
    Image = pillow_image(f"reading {path}")
    with Image.open(path) as image:
        if image.mode in ("RGBA", "LA", "P"):
            image = image.convert("RGBA")
            background = Image.new("RGB", image.size, (255, 255, 255))
            background.paste(image, mask=image.split()[-1])
            image = background
        elif image.mode != "RGB":
            image = image.convert("RGB")
        return np.asarray(image)


def write_frame(path: str, frame: np.ndarray) -> None:
    """Writes an (H, W, 3) uint8 array as an image file (format from the
    extension)."""
    pillow_image(f"writing {path}").fromarray(frame).save(path)


class Video:
    """A video on disk (frames read lazily) or in memory."""

    def __init__(self):
        self.root: Optional[str] = None
        self.frame_paths: List[str] = []
        self.actions: List[int] = []
        self.rewards: List[float] = []
        self.metadata: List[dict] = []
        self.dones: List[bool] = []
        self._frames: Optional[List[np.ndarray]] = None  # in-memory frames

    def load(self, path: str) -> "Video":
        """Reads a video directory: its frame list and its pickles."""
        if not os.path.isdir(path):
            raise FileNotFoundError(f"Video directory '{path}' does not exist")
        self.root = path
        files = sorted(f for f in os.listdir(path)
                       if os.path.splitext(f)[1].lower() in _EXTENSIONS)
        self.frame_paths = [os.path.join(path, f) for f in files]
        if not self.frame_paths:
            raise ValueError(f"Video directory '{path}' contains no frames")
        count = len(self.frame_paths)
        self.actions = self._load_pickle(path, "actions.pkl", count, default=0)
        self.rewards = self._load_pickle(path, "rewards.pkl", count, default=0.0)
        self.metadata = self._load_pickle(path, "metadata.pkl", count, default={})
        self.dones = self._load_pickle(path, "dones.pkl", count, default=False)
        return self

    @staticmethod
    def _load_pickle(path: str, name: str, count: int, default):
        """A per-frame pickle, None entries replaced by ``default`` and the
        list cut or padded to ``count``."""
        file_path = os.path.join(path, name)
        if not os.path.isfile(file_path):
            return [default] * count
        with open(file_path, "rb") as f:
            values = pickle.load(f)
        values = [default if v is None else v for v in values]
        if len(values) < count:
            values = values + [default] * (count - len(values))
        return values[:count]

    def get_frames_count(self) -> int:
        return len(self._frames) if self._frames is not None else len(self.frame_paths)

    def get_frame_at(self, idx: int) -> np.ndarray:
        """Frame ``idx`` as an (H, W, 3) uint8 array."""
        if self._frames is not None:
            return self._frames[idx]
        return read_frame(self.frame_paths[idx])

    def add_content(self, frames: List[np.ndarray], actions: List[int], rewards: List[float],
                    metadata: List[dict], dones: List[bool]) -> "Video":
        """Fills the video from memory: (H, W, 3) uint8 frames; a missing
        list or entry takes its default."""
        self._frames = [np.asarray(f, dtype=np.uint8) for f in frames]
        n = len(self._frames)

        def filled(values, default):
            values = [default] * n if values is None else list(values)
            return [default if v is None else v for v in values]

        self.actions = filled(actions, 0)
        self.rewards = filled(rewards, 0.0)
        self.metadata = filled(metadata, {})
        self.dones = filled(dones, False)
        return self

    def save(self, path: str, extension: str = "png") -> "Video":
        """Writes the frames and the pickles in the on-disk format."""
        os.makedirs(path, exist_ok=True)
        for i in range(self.get_frames_count()):
            write_frame(os.path.join(path, f"{i:05d}.{extension}"), self.get_frame_at(i))
        for name, values in (("actions.pkl", self.actions), ("rewards.pkl", self.rewards),
                             ("metadata.pkl", self.metadata), ("dones.pkl", self.dones)):
            with open(os.path.join(path, name), "wb") as f:
                pickle.dump(list(values), f)
        self.root = path
        return self
