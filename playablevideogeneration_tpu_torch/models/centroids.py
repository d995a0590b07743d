"""Action-centroid EMA estimation.

Counterpart of ``playablevideogeneration_tpu/models/centroids.py``.  The
centroids are an f32 buffer of ``Caddy``; ``update_centroids`` returns the
new value detached, and the caller stores it.
"""
from __future__ import annotations

import torch

from playablevideogeneration_tpu_torch.parallel import mesh


def init_centroids(generator: torch.Generator, centroids_count: int,
                   space_dimensions: int) -> torch.Tensor:
    """N(0, 1) initialisation (reference centroid_estimator.py:27-28)."""
    return torch.randn((centroids_count, space_dimensions), generator=generator)


@torch.no_grad()
def update_centroids(centroids: torch.Tensor, points_priors: torch.Tensor,
                     centroid_assignments: torch.Tensor, alpha: float) -> torch.Tensor:
    """EMA update from soft-assignment weighted means, in f32 whatever the
    compute dtype, over the global batch in a data-parallel step (the
    weighted sums and the weights reduced over the ranks before the
    division), so every rank keeps the same centroids.

    :param centroids: (K, D) current estimates
    :param points_priors: (..., 2, D) per-point (mean, variance)
    :param centroid_assignments: (..., K) soft assignment probabilities
    :return: (K, D) updated centroids, detached
    """
    k, d = centroids.shape
    means = points_priors.reshape(-1, 2, d)[:, 0].float()
    assign = centroid_assignments.reshape(-1, k).float()
    sums = mesh.sum_over_ranks(torch.cat([(assign.t() @ means).flatten(), assign.sum(dim=0)]))
    estimate = sums[:k * d].view(k, d) / sums[k * d:, None]
    new = centroids.float() * (1.0 - alpha) + estimate * alpha
    return new.to(centroids.dtype)


def compute_variations(points: torch.Tensor, centroid_assignments: torch.Tensor,
                       centroids: torch.Tensor) -> torch.Tensor:
    """Assignment-weighted (point - centroid) variation vectors:
    sum_k a_k (p - c_k) = p * sum_k a_k - a @ c.

    :param points: (..., D)
    :param centroid_assignments: (..., K)
    :param centroids: (K, D)
    :return: (..., D)
    """
    k, d = centroids.shape
    p = points.reshape(-1, d)
    a = centroid_assignments.reshape(-1, k)
    # JAX promotes bf16 assignments against the f32 points and centroids.
    variations = p * a.sum(dim=-1, keepdim=True) - a.to(p.dtype) @ centroids.to(p.dtype)
    return variations.reshape(points.shape)


def average_centroid_distance(centroids: torch.Tensor) -> torch.Tensor:
    """Mean pairwise L2 distance between centroids (reference trainer.py:188-203)."""
    k = centroids.shape[0]
    diff = centroids[None, :, :] - centroids[:, None, :]
    dist = torch.sqrt((diff ** 2).sum(dim=-1) + 1e-12).sum()
    return dist / (k * (k - 1))
