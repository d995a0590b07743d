"""FID: the Fréchet Inception Distance.

Counterpart of ``playablevideogeneration_tpu/evaluation/metrics/fid.py``.
The extractor is any callable (N, H, W, 3) frames in [0, 1] -> (N, D)
activations, ``inception.make_fid_extractor`` in the evaluation; without
converted Inception weights the dataset evaluator records
``fid_unavailable`` (a distance over random features would mean nothing).
The statistics stream in float64 on the host, and the distance is
``frame_metrics.frechet_distance``.
"""
from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np

from playablevideogeneration_tpu_torch.evaluation.metrics.frame_metrics import frechet_distance


def compute_statistics_from_frames(
    extractor: Callable[[np.ndarray], np.ndarray],
    frame_batches: Iterable[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray]:
    """The mean and the unbiased covariance of the activations of every
    frame, accumulated batch by batch in float64."""
    count = 0
    sum_x = None
    sum_xxt = None
    for frames in frame_batches:
        acts = np.asarray(extractor(np.asarray(frames)), np.float64)
        if sum_x is None:
            d = acts.shape[1]
            sum_x = np.zeros((d,))
            sum_xxt = np.zeros((d, d))
        count += acts.shape[0]
        sum_x += acts.sum(axis=0)
        sum_xxt += acts.T @ acts
    if count < 2:
        raise ValueError("Need at least 2 frames for FID statistics")
    mu = sum_x / count
    # As np.cov(rowvar=False).
    sigma = (sum_xxt - count * np.outer(mu, mu)) / (count - 1)
    return mu, sigma


def fid_from_statistics(mu1, sigma1, mu2, sigma2) -> float:
    return frechet_distance(mu1, sigma1, mu2, sigma2)


def compute_fid(extractor, reference_frames: Iterable[np.ndarray],
                generated_frames: Iterable[np.ndarray]) -> float:
    mu1, s1 = compute_statistics_from_frames(extractor, reference_frames)
    mu2, s2 = compute_statistics_from_frames(extractor, generated_frames)
    return fid_from_statistics(mu1, s1, mu2, s2)
