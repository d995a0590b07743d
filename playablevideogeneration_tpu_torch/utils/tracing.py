"""Host spans at the port's layer boundaries, tallied in the process.

``with span(name):`` times a stretch of host code.  It always adds one
and the elapsed ``time.perf_counter`` seconds to the process's tally of
``name``; while a ``torch.profiler`` session runs, it also records a host
event named ``pvg.<name>``, on the clock of the profiler's device
operations, so that an idle gap on the device can be put down to the span
the host was inside.  With no profiler running a span costs two clock
reads, one C call and the tally's update.  Nothing turns it on or off.

The event is a ``RecordFunction`` of the operators' scope, as a
``torch.profiler.record_function`` is of the user's scope: a user range
is also drawn on the device's timeline, from its first kernel to its
last, where a reader of device time would take it for an operation.

``tallies()`` copies the tallies: two copies' difference is what the
spans between them took.

The spans, each at a host boundary (none runs inside a function that a
``graphs.Program`` captures, where it would fire only at the capture):

- ``loader.get``: the training loop taking one batch from
  ``data.loader.DataLoader``, its wait for the workers included;
- ``train.step``: ``Trainer.train_step``, and inside it ``train.upload``
  (the batch's copy to the device), ``train.optimizer`` (Adam and the
  schedule) and ``train.readback`` (the metrics' transfer to the host,
  which waits for the device);
- ``program.capture``: a ``graphs.Program``'s warm-up and recording;
  ``program.replay``: one call of a program;
- ``play.call``: one call of a ``PlaySession`` method that returns frames,
  and inside it ``play.readback``, the frames' copy to the host;
- ``detect.call``: one call of the Faster R-CNN person-box backend
  (``evaluation.metrics.frcnn.make_person_box_backend``), and inside it
  ``detect.readback`` (the boxes, scores and labels to the host, which
  waits for the device) and ``detect.boxes`` (the score threshold and the
  boxes as tuples); the frames' copy to the device is in the call's
  ``program.replay``;
- ``detect.select``: ``TennisPlayerDetector.__call__``'s court filter and
  tallest-box choice over the boxes of a sequence.

A span is one object per name in the process, kept by the code that
enters it, so that entering costs no allocation.  It is not reentrant: the
spans of one name do not nest, and run on one thread at a time.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast

PREFIX = "pvg."

_spans: Dict[str, "Span"] = {}
_clock = time.perf_counter
_profiling = torch.autograd._profiler_enabled


class Span:
    """``with span:`` adds one and the block's seconds to ``count`` and
    ``seconds`` and, under the profiler, records the block as
    ``pvg.<name>``.  ``with span(**args):`` gives the event ``args``, an
    identity such as the global step, shown with the profiler's
    ``record_shapes``."""

    __slots__ = ("name", "count", "seconds", "args", "_event", "_start")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.seconds = 0.0
        self.args: Dict[str, int] = {}

    def __call__(self, **args) -> "Span":
        self.args = args
        return self

    def __enter__(self) -> "Span":
        self._event = None
        if _profiling():
            self._event = _RecordFunctionFast(PREFIX + self.name, (), self.args)
            self._event.__enter__()
        self._start = _clock()
        return self

    def __exit__(self, kind, value, traceback) -> None:
        self.seconds += _clock() - self._start
        self.count += 1
        if self._event is not None:
            self._event.__exit__(kind, value, traceback)


def span(name: str) -> Span:
    """The process's span named ``name``."""
    found = _spans.get(name)
    if found is None:
        found = _spans[name] = Span(name)
    return found


def tallies() -> Dict[str, Tuple[int, float]]:
    """{name: (count, seconds)} of every span ended so far in the process."""
    return {name: (s.count, s.seconds) for name, s in list(_spans.items()) if s.count}
