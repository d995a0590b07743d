"""Action-space quality metrics: per-action movement statistics and SVM
action-classification accuracy.

Counterpart of
``playablevideogeneration_tpu/evaluation/metrics/action_metrics.py``,
host-side numpy and scipy.  The classification needs scikit-learn; without
it ``action_classification_score`` records
``action_classification_unavailable``, as the evaluator records every
missing backbone.
"""
from __future__ import annotations

from statistics import mean
from typing import Dict

import numpy as np
from scipy.stats import kurtosis

_QUANTILES = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]


def action_variance(actions: np.ndarray, vectors: np.ndarray,
                    actions_count: int) -> Dict:
    """Statistics of the movement vectors grouped by inferred action, and
    over all of them."""
    vector_size = vectors.shape[-1]
    actions = np.reshape(actions, (-1,))
    vectors = np.reshape(vectors, (-1, vector_size))
    total = vectors.shape[0]

    results: Dict = {}
    all_avg_variances = []
    for action_idx in range(actions_count):
        sel = actions == action_idx
        if sel.sum() == 0:
            continue
        current = vectors[sel]
        variance_vector = np.var(current, axis=0)
        avg_variance = float(np.mean(variance_vector))
        all_avg_variances.append(avg_variance)
        results[f"action_variance/mean_vector/{action_idx}"] = \
            np.mean(current, axis=0).tolist()
        results[f"action_variance/kurtosis/{action_idx}"] = \
            kurtosis(current, axis=0).tolist()
        results[f"action_variance/quantiles/{action_idx}"] = \
            np.quantile(current, _QUANTILES, axis=0).tolist()
        results[f"action_variance/variance_vector/{action_idx}"] = \
            variance_vector.tolist()
        results[f"action_variance/avg_variance/{action_idx}"] = avg_variance
        results[f"action_variance/frequency/{action_idx}"] = \
            float(current.shape[0] / total)

    results["action_variance/avg_variance/mean"] = \
        mean(all_avg_variances) if all_avg_variances else 0.0
    results["action_variance/mean_vector/global"] = \
        np.mean(vectors, axis=0).tolist()
    results["action_variance/quantiles/global"] = \
        np.quantile(vectors, _QUANTILES, axis=0).tolist()
    results["action_variance/variance_vector/global"] = \
        np.var(vectors, axis=0).tolist()
    results["action_variance/avg_variance/global"] = \
        float(np.mean(np.var(vectors, axis=0)))
    return results


def action_classification_score(actions: np.ndarray, vectors: np.ndarray,
                                actions_count: int) -> Dict:
    """Accuracies of four SVMs (linear, rbf, poly, one-vs-one linear) that
    predict the inferred action from the movement vector, fitted and scored
    on the same pairs."""
    try:
        from sklearn import svm
        from sklearn.metrics import accuracy_score
        from sklearn.multiclass import OneVsOneClassifier
    except ImportError:
        return {"action_classification_unavailable": "scikit-learn not installed"}

    vector_size = vectors.shape[-1]
    actions = np.reshape(actions, (-1,))
    vectors = np.reshape(vectors, (-1, vector_size))

    results: Dict = {}
    classifiers = {
        "linear": lambda: svm.SVC(kernel="linear"),
        "rbf": lambda: svm.SVC(kernel="rbf"),
        "poly": lambda: svm.SVC(kernel="poly"),
        "linear_ovo": lambda: OneVsOneClassifier(svm.SVC(kernel="linear")),
    }
    for name, make in classifiers.items():
        try:
            clf = make()
            clf.fit(vectors, actions)
            predictions = clf.predict(vectors)
            results[f"action_classification/{name}/accuracy"] = \
                float(accuracy_score(actions, predictions))
        except Exception as e:  # degenerate inputs (single class etc.)
            results[f"action_classification/{name}/accuracy"] = float("nan")
            results[f"action_classification/{name}/error"] = str(e)
    return results
