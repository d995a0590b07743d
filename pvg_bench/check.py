"""The numbers that decide ``correct``: the program's outputs against the
plain reference's.

Training cells (the first steps after set-up, through the window's own call
and feed), each against the reference's same steps from the same state:

- ``statistics_gap``: for each BatchNorm running statistic after the first
  step (folded from that step's batch statistics of E, A, R and D), the
  distance between the program's and the reference's, over the larger of
  the reference's move from the initial value and the median move; the
  median over the statistics;
- ``centroids_gap``: the same for the action centroids after the first
  step (their EMA update from the batch's action posteriors);
- ``update_norm_gap``: for each parameter, the gap between the norms of
  its change over the checked steps in the program and in the reference,
  over the larger of the reference's and the median leaf's; the median
  over the leaves (a step that leaves the state unchanged reads 1 there);
- ``descent_gap``: for each parameter, the gap between the first-order
  loss changes that the program's and the reference's changes over the
  checked steps make along the reference's first gradient, over the
  largest the reference's could make (``descent_gaps``), read at the
  tenth part of the leaves (``drive.DESCENT_QUANTILE``).  It sees
  direction, which the norms do not: Adam's first updates are nearly
  lr * sign(gradient), so a step of the wrong sign leaves every norm as
  it is and reads 2 here, a state left unchanged or moved double 1.

Beside them, not compared, the first step's loss gap, the first
gradient's norm gaps (median and worst leaf, as Adam took it, the port's
worked out from its first moment), its cosine gap, the worst step's loss,
the worst leaf's change and ``descent_gap`` at the median and the worst
leaf: in bfloat16 these read alike or above the fp8 control's readings,
because train-mode BatchNorm over channels of nearly no batch variance
multiplies rounding (`PERF.md` gives the readings and the witnesses).
Leaves whose
reference gradient is under ``QUIET_LEAF`` of the median leaf's move under
Adam by round-off alone (``state_to_hidden``, unused in the full phase,
and ``mean_fc.bias``, which cancels in the successor - predecessor
directions) and are left out, by this rule and not by name.

Play cells: ``frame_gap``, over every frame of the checked requests, the
worst frame's mean of the uint8 levels by which a pixel misses the
reference's beyond the first: the port converts to bytes in bfloat16,
whose spacing is half a level to a level there, so one level is its own
rounding.  The worst frame's mean absolute difference is a reading.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import numpy as np
import torch

QUIET_LEAF = 1e-3


def relative_loss_gap(losses: Sequence[float], reference: Sequence[float]) -> float:
    if len(losses) != len(reference):
        raise ValueError(f"{len(losses)} losses against {len(reference)}")
    return max(abs(a - b) / abs(b) for a, b in zip(losses, reference))


def kept_leaves(reference_gradients: Dict[str, torch.Tensor]) -> List[str]:
    norms = {n: float(g.norm()) for n, g in reference_gradients.items()}
    floor = QUIET_LEAF * statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= floor]


def norm_gaps(program: Dict[str, float], reference: Dict[str, float],
              leaves: Sequence[str]) -> List[float]:
    """For each of ``leaves``, |program norm - reference norm| / max(that
    reference norm, the median reference norm over ``leaves``)."""
    median = statistics.median(reference[n] for n in leaves)
    return [abs(program[n] - reference[n]) / max(reference[n], median) for n in leaves]


def moved_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               start: Dict[str, torch.Tensor], names: Sequence[str]) -> List[float]:
    """For each of ``names``, how far the program's tensor lies from the
    reference's, over the larger of how far the reference's moved from
    ``start`` and the median such move: ||got - want|| / max(||want -
    start||, median)."""
    moved = {n: float((want[n] - start[n]).norm()) for n in names}
    median = statistics.median(moved.values())
    return [float((got[n] - want[n]).norm()) / max(moved[n], median) for n in names]


def descent_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                 start: Dict[str, torch.Tensor], gradients: Dict[str, torch.Tensor],
                 names: Sequence[str]) -> List[float]:
    """For each of ``names``, how far the program's change from ``start``
    departs from the reference's along the reference's first gradient g:
    |g . (got - want)| / sum |g * (want - start)|, the gap between the two
    first-order loss changes over the largest that the reference's change
    could give.  A sound run reads near 0, a state left unchanged or moved
    double 1, a change of the wrong sign 2."""
    gaps = []
    for n in names:
        g = gradients[n].double()
        scale = float((g * (want[n] - start[n]).double()).abs().sum())
        gap = abs(float((g * (got[n] - want[n]).double()).sum()))
        gaps.append(gap / scale if scale > 0 else math.inf)
    return gaps


def cosine_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """1 - cos(a, b), the two flattened; 1 where either is zero."""
    a, b = a.flatten().double(), b.flatten().double()
    denominator = float(a.norm() * b.norm())
    return 1.0 - float(a @ b) / denominator if denominator > 0 else 1.0


def frame_gaps(frames: np.ndarray, reference: np.ndarray) -> Dict[str, float]:
    """``frame_gap`` and the worst frame's mean absolute difference."""
    if frames.shape != reference.shape:
        raise ValueError(f"frames {frames.shape} against {reference.shape}")
    diff = np.abs(frames.astype(np.int16) - reference.astype(np.int16)).reshape(len(frames), -1)
    return {"frame_gap": float(np.maximum(diff - 1, 0).mean(axis=1).max()),
            "frame_mean_gap": float(diff.mean(axis=1).max())}


def judged(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number without a limit is an error."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return {n: {"value": v, "limit": limits[n]} for n, v in numbers.items()}


def passed(checks: Dict[str, dict]) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
