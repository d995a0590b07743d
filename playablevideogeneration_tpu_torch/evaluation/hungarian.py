"""Hungarian matching of predicted and ground-truth action labels.

Counterpart of ``playablevideogeneration_tpu/evaluation/hungarian.py``:
host-side numpy and scipy.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def hungarian_match(predictions: np.ndarray, ground_truth: np.ndarray,
                    actions_count: int) -> List[Tuple[int, int]]:
    """The (model action, ground-truth action) assignment with the most
    agreements."""
    num_correct = np.zeros((actions_count, actions_count))
    for c1 in range(actions_count):
        for c2 in range(actions_count):
            num_correct[c1, c2] = int(((predictions == c1) & (ground_truth == c2)).sum())
    rows, cols = linear_sum_assignment(len(ground_truth) - num_correct)
    return list(zip(rows.tolist(), cols.tolist()))


def compute_actions_accuracy(predictions: np.ndarray, ground_truth: np.ndarray,
                             actions_count: int) -> Tuple[float, Dict[int, int]]:
    """Accuracy under the best mapping, and the ground-truth -> model
    action map that drives the ground-truth action sampler."""
    predictions = np.asarray(predictions).reshape(-1)
    ground_truth = np.asarray(ground_truth).reshape(-1)
    match = hungarian_match(predictions, ground_truth, actions_count)

    reordered = np.zeros_like(predictions)
    for pred_i, target_i in match:
        reordered[predictions == pred_i] = target_i
    accuracy = float((reordered == ground_truth).mean()) if len(ground_truth) else 0.0
    return accuracy, {gt: int(model) for model, gt in match}
