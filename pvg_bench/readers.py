"""Per-layer metrics: one small reader per metric, found by its name.

``layer_metrics/<name>.py`` defines ``read(reading) -> float or None``.
A reader that finds nothing to read returns None, and the metric is left
out of the result's line; none returns 0 for a share of a roofline or a
peak.
"""
from __future__ import annotations

import functools
import importlib.util
import os
from dataclasses import dataclass
from typing import Callable, Optional

from pvg_bench import counts
from pvg_bench.drive import Cell, Outcome

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Reading:
    cell: Cell
    outcome: Outcome

    @property
    def context(self) -> dict:
        return self.outcome.context

    @property
    def trace(self):
        return self.outcome.trace

    @functools.cached_property
    def play_counts(self) -> dict:
        return counts.play_counts(self.cell.config)

    @functools.cached_property
    def train_counts(self) -> dict:
        c = self.context
        return counts.train_counts(self.cell.config, c["batch"], c["frames"], c["global_step"])

    def kernel_share(self, kernel: str, bytes_per_unit: float, units: float) -> Optional[float]:
        """The share in % of ``kernel``'s roofline over the traced stretch:
        ``units`` times ``bytes_per_unit`` at the peak bandwidth, over the
        device time of the operations whose name holds ``kernel``."""
        if self.trace is None:
            return None
        measured = self.trace.device_seconds(lambda name: kernel in name)
        if measured <= 0:
            return None
        return 100.0 * bytes_per_unit * units / counts.HBM_BYTES_PER_S / measured

    def idle_share(self) -> Optional[float]:
        """1 - busy / window in %, both from the device-only trace of the
        traced stretch: the seconds in which some operation ran on the
        device, over the span between the markers that the device runs just
        before and just after the stretch."""
        if self.trace is None or self.trace.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)


def load_reader(name: str) -> Callable[[Reading], Optional[float]]:
    path = os.path.join(HERE, "layer_metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"pvg_bench.layer_metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
