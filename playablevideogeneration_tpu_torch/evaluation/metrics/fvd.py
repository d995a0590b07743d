"""FVD: the Fréchet Video Distance.

Counterpart of ``playablevideogeneration_tpu/evaluation/metrics/fvd.py``.
The embedder is any callable (N, T, H, W, 3) videos in [0, 1] -> (N, D)
embeddings, ``i3d.make_fvd_embedder`` in the evaluation.  Videos reach it
in batches of ``EMBED_BATCH``, as the reference's TensorFlow graph takes
them (the last one may be shorter, and a batch of the stream is never
split); the statistics are float64 on the host, and the distance is
``frame_metrics.frechet_distance``, shared with the FID.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np

from playablevideogeneration_tpu_torch.evaluation.metrics.frame_metrics import frechet_distance

EMBED_BATCH = 16


def _statistics(embedder, video_batches: Iterable[np.ndarray]):
    buffer = []
    embeddings = []

    def flush():
        if buffer:
            videos = np.concatenate(buffer, axis=0)
            embeddings.append(np.asarray(embedder(videos), np.float64))
            buffer.clear()

    pending = 0
    for videos in video_batches:
        buffer.append(np.asarray(videos))
        pending += videos.shape[0]
        if pending >= EMBED_BATCH:
            flush()
            pending = 0
    flush()
    acts = np.concatenate(embeddings, axis=0)
    if acts.shape[0] < 2:
        raise ValueError("Need at least 2 videos for FVD statistics")
    mu = acts.mean(axis=0)
    sigma = np.cov(acts, rowvar=False)
    return mu, np.atleast_2d(sigma)


def compute_fvd(embedder: Callable[[np.ndarray], np.ndarray],
                reference_videos: Iterable[np.ndarray],
                generated_videos: Iterable[np.ndarray]) -> float:
    """The Fréchet distance between the embeddings of the two streams of
    (B, T, H, W, 3) video batches."""
    mu1, s1 = _statistics(embedder, reference_videos)
    mu2, s2 = _statistics(embedder, generated_videos)
    return frechet_distance(mu1, s1, mu2, s2)


def naive_video_embedder(videos: np.ndarray, dims: int = 64) -> np.ndarray:
    """A deterministic embedder without weights, for testing the pipeline:
    per video the colour means and deviations, the mean absolute frame
    difference and a 4x4 grid of temporal means, padded or cut to ``dims``
    (not comparable to I3D's FVD; the reference's test stub plays the same
    part)."""
    v = np.asarray(videos, np.float64)
    n, t = v.shape[:2]
    feats = []
    feats.append(v.mean(axis=(1, 2, 3)))
    feats.append(v.std(axis=(1, 2, 3)))
    diff = np.abs(np.diff(v, axis=1))
    feats.append(diff.mean(axis=(1, 2, 3)))
    gh = gw = 4
    h, w = v.shape[2], v.shape[3]
    grid = v[:, :, : h - h % gh, : w - w % gw]
    grid = grid.reshape(n, t, gh, h // gh, gw, w // gw, -1).mean(axis=(1, 3, 5))
    feats.append(grid.reshape(n, -1))
    out = np.concatenate(feats, axis=1)
    if out.shape[1] < dims:
        out = np.pad(out, ((0, 0), (0, dims - out.shape[1])))
    return out[:, :dims]
