"""Logging: stdout and, optionally, Weights & Biases.

Counterpart of ``playablevideogeneration_tpu/utils/logging.py``.  wandb is
optional; when it is missing or off the logger prints only.  A logger
built with ``enabled=False`` (every rank but rank 0 of a data-parallel
run) prints and logs nothing.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional


class AverageMeter:
    """Running means keyed by name."""

    def __init__(self):
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    def add(self, values: Dict[str, float]):
        for key, value in values.items():
            self._sums[key] += float(value)
            self._counts[key] += 1

    def pop(self, key: str) -> float:
        if key not in self._counts:  # the defaultdict would make up a 0.0
            raise KeyError(key)
        value = self._sums[key] / max(self._counts[key], 1)
        del self._sums[key]
        del self._counts[key]
        return value


class Logger:
    def __init__(self, config: Optional[dict] = None, use_wandb: bool = False,
                 project: str = "video-generation", enabled: bool = True):
        self.config = config
        self.enabled = enabled
        self._wandb = None
        if use_wandb and enabled:
            try:
                import wandb

                wandb.init(project=project,
                           name=(config or {}).get("logging", {}).get("run_name"),
                           config=config)
                self._wandb = wandb
            except Exception as e:  # wandb is optional: report and print only
                print(f"[logger] wandb unavailable ({e}); falling back to stdout")

    def print(self, *args, **kwargs):
        if self.enabled:
            print(*args, **kwargs, flush=True)

    def histogram(self, np_histogram):
        """A (counts, bin edges) pair as a wandb Histogram; None when wandb
        is off."""
        if self._wandb is None:
            return None
        counts, edges = np_histogram
        return self._wandb.Histogram(
            np_histogram=(list(map(float, counts)), list(map(float, edges))))

    def log(self, values: Dict, step: Optional[int] = None):
        if self._wandb is not None:
            self._wandb.log(values, step=step)
