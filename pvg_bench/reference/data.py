"""The training batches worked out again from the seeded videos.

A frozen copy of what the port's ``data/video_dataset.py`` and
``data/loader.py`` do with a list of videos: the sample index space of a
sequence length, a sample's observations (``observations_count`` of them,
``skip_frames + 1`` apart, each stacking ``observation_stacking`` frames
back in time, clamped at the sequence start, newest first), and the
shuffled order of an epoch (numpy's ``default_rng(seed).shuffle``, batches
taken in order, the incomplete last one dropped).  It imports nothing of
the port or of JAX.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from pvg_bench.videos import to_model_range


def epoch_order(sample_count: int, batch_size: int, seed: int, epochs: int = 1
                ) -> List[np.ndarray]:
    """The sample indices of each batch of the first ``epochs`` epochs of a
    loader seeded with ``seed`` (one generator shuffles every epoch)."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(epochs):
        indices = np.arange(sample_count)
        rng.shuffle(indices)
        usable = sample_count // batch_size * batch_size
        batches += [indices[s:s + batch_size] for s in range(0, usable, batch_size)]
    return batches


def sample_count(frame_counts: Sequence[int], batching: dict, frames: int) -> int:
    block = frames + (frames - 1) * batching["skip_frames"]
    return sum(max(n - block + 1, 0) for n in frame_counts)


def sample(videos: Sequence[np.ndarray], batching: dict, frames: int, index: int
           ) -> np.ndarray:
    """Sample ``index``: (T, H, W, 3 * stacking) float32 in [-1, 1]."""
    skip, stacking = batching["skip_frames"], batching["observation_stacking"]
    block = frames + (frames - 1) * skip
    for video in videos:
        available = max(len(video) - block + 1, 0)
        if index < available:
            break
        index -= available
    else:
        raise IndexError(index)
    stride = skip + 1
    first = index % stride
    observations = []
    for i in range(frames):
        at = index + i * stride
        observations.append(np.concatenate(
            [to_model_range(video[max(at - k * stride, first)]) for k in range(stacking)],
            axis=-1))
    return np.stack(observations)


def batch(videos: Sequence[np.ndarray], batching: dict, frames: int, indices) -> np.ndarray:
    """(B, T, 3 * stacking, H, W) float32: the batch channels first."""
    rows = np.stack([sample(videos, batching, frames, int(i)) for i in indices])
    return np.ascontiguousarray(rows.transpose(0, 1, 4, 2, 3))
