"""Action-space plots: direction-space scatter (TSNE above 2-D) and
action-state trajectories.

Counterpart of ``playablevideogeneration_tpu/utils/tensor_displayer.py``:
host-side numpy, matplotlib and (above 2-D) scikit-learn.  matplotlib is
optional: without it the plots are skipped.
"""
from __future__ import annotations

import numpy as np


def _get_plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        return None


def _project_2d(points: np.ndarray) -> np.ndarray:
    """(N, D) points in 2-D: padded for D = 1, as they are for D = 2, TSNE
    above."""
    d = points.shape[-1]
    if d == 1:
        return np.concatenate([points, np.zeros_like(points)], axis=-1)
    if d == 2:
        return points
    from sklearn.manifold import TSNE

    perplexity = min(30.0, max(2.0, points.shape[0] / 4.0))
    return TSNE(n_components=2, perplexity=perplexity, init="random",
                random_state=0).fit_transform(points)


def show_action_directions(estimated_centroids: np.ndarray,
                           action_directions_distribution: np.ndarray,
                           action_probabilities: np.ndarray, filename: str):
    """Scatter of the action-direction means coloured by the most likely
    action, with the centroids over them."""
    plt = _get_plt()
    if plt is None:
        return
    centroids = np.asarray(estimated_centroids)
    dirs = np.asarray(action_directions_distribution)
    means = dirs.reshape((-1,) + dirs.shape[-2:])[:, 0]  # (N, D)
    probs = np.asarray(action_probabilities).reshape(-1, centroids.shape[0])
    labels = probs.argmax(-1)

    projected = _project_2d(np.concatenate([means, centroids], axis=0))
    p_means, p_cents = projected[:len(means)], projected[len(means):]

    fig, ax = plt.subplots(figsize=(6, 6))
    scatter = ax.scatter(p_means[:, 0], p_means[:, 1], c=labels, s=8, cmap="tab10", alpha=0.6)
    ax.scatter(p_cents[:, 0], p_cents[:, 1], c=np.arange(len(p_cents)), cmap="tab10",
               marker="X", s=200, edgecolors="black")
    fig.colorbar(scatter, ax=ax, label="action")
    ax.set_title("action direction space")
    fig.savefig(filename)
    plt.close(fig)


def show_action_states(action_states: np.ndarray, action_probabilities: np.ndarray,
                       filename: str, max_sequences: int = 16):
    """Action-state trajectories over time, one line per sequence."""
    plt = _get_plt()
    if plt is None:
        return
    states = np.asarray(action_states)
    if states.ndim == 4:  # (B, T, 2, D) distribution -> means
        states = states[:, :, 0]
    fig, ax = plt.subplots(figsize=(6, 6))
    for traj in states[:max_sequences]:
        if traj.shape[-1] == 1:
            ax.plot(np.arange(len(traj)), traj[:, 0], alpha=0.7)
        else:
            ax.plot(traj[:, 0], traj[:, 1], alpha=0.7, marker="o", markersize=2)
    ax.set_title("action state trajectories")
    fig.savefig(filename)
    plt.close(fig)
