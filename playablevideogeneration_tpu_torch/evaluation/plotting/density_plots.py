"""Action-space plots: per-action movement densities and mean vectors.

Counterpart of
``playablevideogeneration_tpu/evaluation/plotting/density_plots.py``, with
the reference's four plotters and file names: the per-dimension 1-D
density, the per-action 2-D density, the merged 2-D scatter and the
per-action mean vectors.  The plotted y is the negated second component;
``axis_inversion=True`` (BAIR) plots (v1, -v0).  Host-side matplotlib
(seaborn for the 2-D densities when installed); without matplotlib every
plot is a no-op.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np


def _get_plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def _flatten_select(actions: np.ndarray, vectors: np.ndarray,
                    axes: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    vector_size = vectors.shape[-1]
    actions = np.reshape(actions, (-1,))
    vectors = np.reshape(vectors, (-1, vector_size))[:, list(axes)]
    return actions, vectors


def _limits(vectors: np.ndarray, xlim, ylim):
    if xlim is None:
        xlim = (float(np.min(vectors[:, 0])), float(np.max(vectors[:, 0])))
    if ylim is None:
        ylim = (float(np.min(vectors[:, 1])), float(np.max(vectors[:, 1])))
    return xlim, ylim


def _orient(vectors: np.ndarray, axis_inversion: bool):
    """Reference plotting orientation (density_plot_2d.py:52-57)."""
    if axis_inversion:
        return vectors[:, 1], -vectors[:, 0]
    return vectors[:, 0], -vectors[:, 1]


def plot_density_1d(actions: np.ndarray, vectors: np.ndarray,
                    actions_count: int, output_directory: str,
                    prefix: str = ""):
    """Per-dimension, per-action 1-D gaussian KDE curves
    (reference density_plot.py:7-52, incl. the 0.25 covariance factor)."""
    plt = _get_plt()
    if plt is None:
        return
    from scipy.stats import gaussian_kde

    vector_size = vectors.shape[-1]
    actions = np.reshape(actions, (-1,))
    vectors = np.reshape(vectors, (-1, vector_size))

    for dim in range(vector_size):
        for a in range(actions_count):
            sel = vectors[actions == a, dim].reshape(-1)
            if sel.size == 0:
                continue
            xs = np.linspace(float(np.min(sel)), float(np.max(sel)), 200)
            try:
                density = gaussian_kde(sel)
                density.covariance_factor = lambda: 0.25
                density._compute_covariance()
                plt.plot(xs, density(xs), label=f"Action {a}")
            except Exception:  # singular data (e.g. constant movements)
                plt.hist(sel, bins=30, density=True, alpha=0.5,
                         label=f"Action {a}")
            plt.legend()
        plt.savefig(os.path.join(output_directory,
                                 f"{prefix}action_density_dim_{dim}.pdf"),
                    dpi=600)
        plt.clf()
    plt.close("all")


def plot_density_2d(actions: np.ndarray, vectors: np.ndarray,
                    actions_count: int, output_directory: str,
                    xlim=None, ylim=None, axis_inversion: bool = False,
                    axes: Sequence[int] = (0, 1), prefix: str = ""):
    """Per-action 2-D KDE density plot (reference density_plot_2d.py:10-65).
    With a single axis selected, the y coordinate is standard-normal noise
    so a 2-D density can still be drawn (reference lines 35-37)."""
    plt = _get_plt()
    if plt is None:
        return
    actions, vectors = _flatten_select(actions, vectors, axes)
    if len(axes) == 1:
        noise = np.random.normal(0, 1, size=vectors.shape)
        vectors = np.concatenate([vectors, noise], axis=1)
    xlim, ylim = _limits(vectors, xlim, ylim)

    for a in range(actions_count):
        sel = vectors[actions == a].reshape(-1, 2)
        plt.plot([0, 0], ylim, "k", linewidth=0.5)
        plt.plot(xlim, [0, 0], "k", linewidth=0.5)
        x_data, y_data = _orient(sel, axis_inversion)
        try:
            import seaborn as sns

            sns.set_style("white")
            ax = sns.kdeplot(x=x_data, y=y_data, cmap="Blues", fill=True)
        except Exception:  # seaborn missing or degenerate data for KDE
            ax = plt.gca()
            ax.scatter(x_data, y_data, s=4, alpha=0.4)
        ax.set(xlim=xlim, ylim=ylim)
        plt.savefig(
            os.path.join(output_directory,
                         f"{prefix}2d_action_density_action_{a}.pdf"),
            dpi=600)
        plt.clf()
    plt.close("all")


def plot_density_2d_merged(actions: np.ndarray, vectors: np.ndarray,
                           actions_count: int, output_directory: str,
                           xlim=None, ylim=None, axis_inversion: bool = False,
                           axes: Sequence[int] = (0, 1), prefix: str = ""):
    """All actions in one scatter, colored by action with a jet colormap
    and colorbar (reference density_plot_2d_merged.py:10-59)."""
    plt = _get_plt()
    if plt is None:
        return
    import matplotlib

    actions, vectors = _flatten_select(actions, vectors, axes)
    xlim, ylim = _limits(vectors, xlim, ylim)

    plt.plot([0, 0], ylim, "k", linewidth=0.5)
    plt.plot(xlim, [0, 0], "k", linewidth=0.5)
    x_data, y_data = _orient(vectors.reshape(-1, 2), axis_inversion)
    cmap = matplotlib.colormaps["jet"].resampled(actions_count)
    plt.scatter(x_data, y_data, c=actions, cmap=cmap, marker=".", alpha=0.25,
                vmin=-0.5, vmax=actions_count - 0.5)
    plt.colorbar(ticks=range(actions_count))
    plt.ylim(ylim)
    plt.xlim(xlim)
    plt.savefig(os.path.join(output_directory,
                             f"{prefix}2d_action_density_merged.pdf"),
                dpi=600)
    plt.clf()
    plt.close("all")


def plot_mean_vectors(actions: np.ndarray, vectors: np.ndarray,
                      actions_count: int, output_directory: str,
                      xlim=None, ylim=None, axis_inversion: bool = False,
                      axes: Sequence[int] = (0, 1), prefix: str = ""):
    """Mean movement per action as labeled point markers
    (reference mean_vector_plot_2d.py:10-62)."""
    plt = _get_plt()
    if plt is None:
        return
    actions, vectors = _flatten_select(actions, vectors, axes)
    xlim, ylim = _limits(vectors, xlim, ylim)

    for a in range(actions_count):
        sel = vectors[actions == a].reshape(-1, 2)
        if not len(sel):
            continue
        mean = sel.mean(axis=0)
        (x_data,), (y_data,) = _orient(mean[None], axis_inversion)
        plt.plot(x_data, y_data, marker="o", label=f"Action {a}")
    plt.plot([0, 0], ylim, "k", linewidth=0.5)
    plt.plot(xlim, [0, 0], "k", linewidth=0.5)
    plt.legend()
    plt.ylim(ylim)
    plt.xlim(xlim)
    plt.savefig(os.path.join(output_directory,
                             f"{prefix}2d_action_directions.pdf"),
                dpi=600)
    plt.clf()
    plt.close("all")


def plot_all(actions: np.ndarray, movements: np.ndarray, actions_count: int,
             output_dir: str, xlim=None, ylim=None,
             axis_inversion: bool = False,
             plot_2d_axes: Optional[Sequence[int]] = None, prefix: str = ""):
    """Emit the reference evaluator's full plot set for one dataset
    (reference dataset_evaluator.py:220-223, dataset_evaluator_bair.py:126-128,
    dataset_evaluator_breakout.py:138-140)."""
    os.makedirs(output_dir, exist_ok=True)
    movements = np.asarray(movements)
    if movements.ndim == 1:
        movements = movements[:, None]
    plot_density_1d(actions, movements, actions_count, output_dir,
                    prefix=prefix)
    if movements.shape[-1] == 1:
        # Breakout-style 1-D movements: 2-D density with noise y axis
        # (reference dataset_evaluator_breakout.py:140).
        plot_density_2d(actions, movements, actions_count, output_dir,
                        xlim=xlim, ylim=ylim, axes=(0,), prefix=prefix)
    else:
        axes = tuple(plot_2d_axes) if plot_2d_axes is not None else (0, 1)
        plot_density_2d(actions, movements, actions_count, output_dir,
                        xlim=xlim, ylim=ylim, axis_inversion=axis_inversion,
                        axes=axes, prefix=prefix)
        plot_density_2d_merged(actions, movements, actions_count, output_dir,
                               xlim=xlim, ylim=ylim,
                               axis_inversion=axis_inversion, axes=axes,
                               prefix=prefix)
        plot_mean_vectors(actions, movements, actions_count, output_dir,
                          xlim=xlim, ylim=ylim, axis_inversion=axis_inversion,
                          axes=axes, prefix=prefix)
