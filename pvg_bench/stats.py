"""The arithmetic of the end-to-end metrics, over all samples of a window."""
from __future__ import annotations

import math
from typing import Sequence


def rate(count: float, seconds: float) -> float:
    """Work completed per second of the window: all of it over all of it."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0 < q < 100) of every value, linearly
    interpolated between order statistics (numpy's default)."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    position = (len(ordered) - 1) * q / 100.0
    low = math.floor(position)
    high = min(low + 1, len(ordered) - 1)
    return ordered[low] + (ordered[high] - ordered[low]) * (position - low)
