"""The device trace of a traced stretch, read from ``torch.profiler``.

``traced(run, host)`` records ``run`` under the profiler (CUPTI on the
card) and returns a ``Trace``: every device operation (kernels, copies and
sets, those a CUDA graph launches included) as (name, start, end) and,
with ``host``, the host events around them.  Busy time is the union of the device intervals
inside the window; an idle gap is charged to the innermost host event
that covers its middle.
"""
from __future__ import annotations

import collections
import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW_SPAN = "pvg_bench.window"
SPAN_PREFIX = "pvg_bench."
SHORT_GAP_S = 20e-6
SHORT_GAPS = "gaps under 20 us between device operations"


@dataclass
class Trace:
    window: Tuple[float, float]  # seconds, on the profiler's clock
    device: List[Tuple[str, float, float]]  # (name, start s, end s)
    host: List[Tuple[str, float, float]]
    # The idle gaps of a second, host-traced run of the same stretch.
    idle_gaps_by_host: Optional[List[List]] = None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def _merged(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device if e > lo and s < hi)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device."""
        return sum(e - s for s, e in self._merged())

    def device_seconds(self, match: Callable[[str], bool]) -> float:
        """Summed device time of the operations whose name ``match``es."""
        return sum(e - s for name, s, e in self.device if match(name))

    def top_device_ops(self, count: int = 10) -> List[List]:
        totals: Dict[str, float] = collections.defaultdict(float)
        for name, s, e in self.device:
            totals[name] += e - s
        return [[n, t] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:count]]

    def _host_at(self, t: float) -> str:
        covering = [(e - s, name) for name, s, e in self.host if s <= t <= e]
        if not covering:
            return "no host event"
        spans = [c for c in covering if c[1].startswith(SPAN_PREFIX) and c[1] != WINDOW_SPAN]
        inner = min(covering)[1]
        span = min(spans)[1] if spans else WINDOW_SPAN
        return inner if inner == span else f"{span} > {inner}"

    def idle_gaps(self, count: int = 10) -> List[List]:
        """Idle seconds of the window by what the host was doing then,
        largest first; gaps shorter than ``SHORT_GAP_S`` (between the
        operations of one graph or one burst of launches) together."""
        lo, hi = self.window
        edges = [lo] + [x for s, e in self._merged() for x in (s, e)] + [hi]
        totals: Dict[str, float] = collections.defaultdict(float)
        for start, end in zip(edges[0::2], edges[1::2]):
            if end - start >= SHORT_GAP_S:
                totals[self._host_at((start + end) / 2)] += end - start
            elif end > start:
                totals[SHORT_GAPS] += end - start
        return [[n, t] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:count]]

    def breakdown(self) -> dict:
        gaps = self.idle_gaps_by_host if self.idle_gaps_by_host is not None else self.idle_gaps()
        return {"device_ops": self.top_device_ops(), "idle_gaps": gaps}


def traced(run: Callable[[], object], host: bool) -> Tuple[object, Trace]:
    """Runs ``run`` under the profiler; returns its result and the trace.

    With ``host`` the profiler records the host's operations and the
    benchmark's spans too, which slows the host; without it only the
    device's operations, between two marker operations that the device
    runs just before and just after ``run``, which set the window.  The
    card's busy time and idle share are read without ``host``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    host = host or not cuda
    activities = ([ProfilerActivity.CPU] if host else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    marker = torch.zeros(1, device="cuda") if cuda else None
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        if not host:
            marker.add_(1)
        with record_function(WINDOW_SPAN):
            result = run()
        if cuda:
            if not host:
                marker.add_(1)
            torch.cuda.synchronize()
    device, events, window = [], [], None
    # Kineto's own records: building the profiler's event list in Python
    # would take longer than the stretch.
    for event in prof.profiler.kineto_results.events():
        start = event.start_ns() * 1e-9
        end = start + event.duration_ns() * 1e-9
        if event.device_type() == torch.autograd.DeviceType.CUDA:
            # A span's annotation on the device's timeline is no operation.
            if not event.name().startswith(SPAN_PREFIX):
                device.append((event.name(), start, end))
        else:
            events.append((event.name(), start, end))
            if event.name() == WINDOW_SPAN:
                window = (start, end)
    if not host:
        window = (min(s for _, s, _ in device), max(e for _, _, e in device))
    if window is None:
        raise RuntimeError("the profiler recorded no window")
    return result, Trace(window=window, device=device, host=events)


def span(name: str, on: bool = True):
    """A host span of the benchmark's own, named ``pvg_bench.<name>``,
    recorded only where ``on`` (in a traced stretch)."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(SPAN_PREFIX + name)
