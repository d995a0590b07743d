"""Sequence dataset over videos.

Counterpart of ``playablevideogeneration_tpu/data/video_dataset.py``.  A
sample is ``observations_count`` observations spaced ``skip_frames + 1``
apart; each observation stacks ``observation_stacking`` frames going back
in time, clamped at the sequence start, newest first along channels.
``set_observations_count`` re-derives the sample index space when the
sequence length is annealed.

Host-side only: samples are numpy arrays, channels last (B, T, H, W, C),
as the JAX package's loader gives them.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set

import numpy as np

from playablevideogeneration_tpu_torch.data.video import Video


@dataclass
class SequenceSample:
    """One dataset element, before collation."""

    observations: np.ndarray  # (T, H, W, 3*stacking) float32, frames newest first
    actions: np.ndarray  # (T,) int32
    rewards: np.ndarray  # (T,) float32
    dones: np.ndarray  # (T,) bool
    video: Video
    initial_frame_index: int


class VideoDataset:
    def __init__(self, path: str, batching_config: Dict,
                 transform: Callable[[np.ndarray], np.ndarray],
                 allowed_videos: Optional[Set[str]] = None):
        """
        :param path: directory holding one video directory per child
        :param batching_config: ``observations_count``,
            ``observation_stacking`` and ``skip_frames`` (the YAML schema)
        :param transform: (H, W, 3) uint8 frame -> (H', W', 3) float32
        :param allowed_videos: optional allowlist of child names
        """
        if not os.path.isdir(path):
            raise FileNotFoundError(f"Dataset directory '{path}' is not a directory")
        contents = sorted(os.listdir(path))
        allowed = set(contents) if allowed_videos is None else allowed_videos
        videos = [Video().load(os.path.join(path, name)) for name in contents
                  if os.path.isdir(os.path.join(path, name)) and name in allowed]
        if not videos:
            raise ValueError(f"No videos found under '{path}'")
        self._setup(videos, batching_config, transform)
        self.path = path

    @classmethod
    def from_videos(cls, videos: Sequence[Video], batching_config: Dict,
                    transform: Callable[[np.ndarray], np.ndarray]) -> "VideoDataset":
        """A dataset over videos held in memory."""
        if not videos:
            raise ValueError("No videos given")
        dataset = cls.__new__(cls)
        dataset._setup(list(videos), batching_config, transform)
        dataset.path = None
        return dataset

    def _setup(self, videos: List[Video], batching_config: Dict, transform) -> None:
        self.all_videos = videos
        self.batching_config = batching_config
        self.observation_stacking = batching_config["observation_stacking"]
        self.skip_frames = batching_config["skip_frames"]
        self.transform = transform
        self.observations_count: Optional[int] = None
        self.set_observations_count(batching_config["observations_count"])

    def set_observations_count(self, observations_count: int):
        """Re-derives the sample index space for a new sequence length."""
        if self.observations_count == observations_count:
            return
        self.observations_count = observations_count
        block = observations_count + (observations_count - 1) * self.skip_frames
        self.available_samples_list = [max(v.get_frames_count() - block + 1, 0)
                                       for v in self.all_videos]
        self._cumulative = np.cumsum([0] + self.available_samples_list)
        self.total_available_samples = int(self._cumulative[-1])

    def __len__(self) -> int:
        return self.total_available_samples

    def __getitem__(self, index: int) -> SequenceSample:
        if index < 0:
            index += self.total_available_samples
        if not 0 <= index < self.total_available_samples:
            raise IndexError(index)
        video_index = int(np.searchsorted(self._cumulative, index, side="right") - 1)
        video_initial_frame = index - int(self._cumulative[video_index])
        video = self.all_videos[video_index]

        stride = self.skip_frames + 1
        observation_indexes = [video_initial_frame + i * stride
                               for i in range(self.observations_count)]
        # The earliest frame a stack may reach back to.
        min_frame = video_initial_frame % stride

        frames_cache: Dict[int, np.ndarray] = {}

        def frame(i: int) -> np.ndarray:
            if i not in frames_cache:
                frames_cache[i] = self.transform(video.get_frame_at(i))
            return frames_cache[i]

        observations = [np.concatenate([frame(max(obs_index - k * stride, min_frame))
                                        for k in range(self.observation_stacking)], axis=-1)
                        for obs_index in observation_indexes]
        actions = np.asarray([video.actions[i] for i in observation_indexes], np.int32)
        rewards = np.asarray([sum(video.rewards[max(i - self.skip_frames, 0): i + 1])
                              for i in observation_indexes], np.float32)
        dones = np.asarray([video.dones[i] for i in observation_indexes], bool)
        return SequenceSample(observations=np.stack(observations, axis=0).astype(np.float32),
                              actions=actions, rewards=rewards, dones=dones, video=video,
                              initial_frame_index=video_initial_frame)


@dataclass
class Batch:
    """A collated batch, channels last."""

    observations: np.ndarray  # (B, T, H, W, 3*stacking)
    actions: np.ndarray  # (B, T)
    rewards: np.ndarray  # (B, T)
    dones: np.ndarray  # (B, T)
    videos: List[Video]
    initial_frames: List[int]


def collate(samples: Sequence[SequenceSample]) -> Batch:
    return Batch(observations=np.stack([s.observations for s in samples]),
                 actions=np.stack([s.actions for s in samples]),
                 rewards=np.stack([s.rewards for s in samples]),
                 dones=np.stack([s.dones for s in samples]),
                 videos=[s.video for s in samples],
                 initial_frames=[s.initial_frame_index for s in samples])
