"""Curve plots from evaluation results files.

Counterpart of
``playablevideogeneration_tpu/evaluation/plotting/results_plotter.py``
(reference evaluation/plotting/results_file_plotter.py:10): reads the
``data.yml`` files that the offline evaluation writes and plots
per-position metric curves, several runs on one figure.  Host-side;
PyYAML and matplotlib are imported when used (without matplotlib the
plots are skipped).

    python -m playablevideogeneration_tpu_torch.evaluation.plotting.results_plotter \\
        --results run_a/data.yml run_b/data.yml --output plots
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional, Sequence

import numpy as np


def _get_plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def load_results(path: str) -> Dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def positional_curve(results: Dict, prefix: str) -> Optional[np.ndarray]:
    """The per-position series ``<prefix>/<i>`` of a results dict, ordered
    by position; None if the metric is absent."""
    pattern = re.compile(rf"^{re.escape(prefix)}/(\d+)$")
    values = {}
    for key, value in results.items():
        match = pattern.match(str(key))
        if match:
            values[int(match.group(1))] = float(value)
    if not values:
        return None
    return np.asarray([values[i] for i in sorted(values)])


def plot_metric_curves(result_paths: Sequence[str], labels: Sequence[str],
                       metrics: Sequence[str], output_dir: str):
    """One figure per metric (``<metric>.pdf``, '/' as '_'), one curve per
    run."""
    plt = _get_plt()
    if plt is None:
        return
    os.makedirs(output_dir, exist_ok=True)
    runs = [load_results(p) for p in result_paths]
    for metric in metrics:
        fig, ax = plt.subplots(figsize=(6, 4))
        plotted = False
        for label, results in zip(labels, runs):
            curve = positional_curve(results, metric)
            if curve is not None:
                ax.plot(np.arange(len(curve)), curve, marker="o", markersize=3, label=label)
                plotted = True
        if plotted:
            ax.set_xlabel("sequence position")
            ax.set_ylabel(metric)
            ax.legend()
            fig.tight_layout()
            fig.savefig(os.path.join(output_dir, f"{metric.replace('/', '_')}.pdf"))
        plt.close(fig)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Plot per-position metric curves from data.yml files")
    parser.add_argument("--results", nargs="+", required=True, help="data.yml paths")
    parser.add_argument("--labels", nargs="+", default=None)
    parser.add_argument("--metrics", nargs="+",
                        default=["mse", "psnr", "ssim", "lpips", "vgg_sim",
                                 "detection/add", "detection/mdr"])
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)
    labels = args.labels or [os.path.basename(os.path.dirname(p)) for p in args.results]
    plot_metric_curves(args.results, labels, args.metrics, args.output)


if __name__ == "__main__":
    main()
