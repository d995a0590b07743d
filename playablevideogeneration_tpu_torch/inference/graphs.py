"""A route of the model captured as one device program: a CUDA graph.

The JAX package compiles each inference route into one program: the play
step is a ``jax.jit``, the scripted rollout one ``lax.scan`` inside a
``jax.jit``, and the builder's forward one ``jax.jit`` per batch shape.
The port's counterpart is a ``torch.cuda.CUDAGraph``: the kernels of one
call recorded once on static buffers and replayed with one launch, and a
new capture for a new shape, as ``jax.jit`` traces again.  A ``Program``
holds one capture:

- ``fn(*state, *inputs)`` returns ``(new_state, outputs)`` and must be
  pure.  ``state`` (a play session's ConvLSTM carries and observation
  window) and ``inputs`` (one call's values) are static tensors that the
  caller owns.  A call copies its values into ``inputs``, replays, and the
  graph ends by copying ``new_state`` into ``state``.
- The outputs are static too: the next call overwrites them, so a caller
  that hands one out hands out a copy (``copied``).
- Before it records, a capture runs ``fn`` a few times on a side stream,
  so that every ctypes kernel is built and loaded, every cuDNN and cuBLAS
  handle and workspace exists and every cast of a weight to the compute
  dtype is cached (``models.layers._CastParameters``).  ``fn`` being pure,
  this changes no state; the generators ``fn`` draws from are restored
  after it.  The graph goes into a memory pool of its own.
- Each generator ``fn`` draws from is registered with the graph, so that a
  replay draws what an eager call would and advances the generator as
  one would.
- The kernels' wrappers count their launches in Python, so a capture
  counts once and a replay not at all.  A program sets the counters back
  after its warm-up and its capture and adds, on every replay, how far
  each moved while it recorded: the counts stay one call's worth per call,
  as eagerly.  The warm-up's launches, whose results are thrown away as a
  compile's would be, are not counted.
- A graph reads the model's parameters and buffers where they lie, but the
  bf16 casts of the weights are cached tensors.  So each call compares
  the version counters of the model's parameters and buffers with those
  at the capture, and captures again when one has moved: an in-place
  update (``load_state_dict``, ``Trainer.load_checkpoint``,
  ``Trainer.load_reference_weights``, an optimizer step) is seen.  A
  tensor that is *replaced* is not: no caller may replace a module tensor
  of the model (``layers.shard_model``, assigning a parameter) while a
  program of it lives.
- A program captures the model in evaluation mode, as the JAX routes run
  with frozen statistics, and refuses a model in training mode.

``CudaGraph`` records and replays.  ``StandIn``, the one test seam, calls
``fn`` on the same static buffers where the graph would replay, so that
the CPU tests hold the buffer handling; ``backend_for`` never chooses it.
A capture that fails raises: there is no eager fallback on the card.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from playablevideogeneration_tpu_torch.ops.cuda.convlstm_gates import (
    fused_lstm_gates,
    fused_lstm_gates_bwd,
)
from playablevideogeneration_tpu_torch.ops.cuda.fused_norm_act import (
    fused_batch_norm_leaky_relu,
)

# The kernel wrappers whose ``launches`` a program keeps.
COUNTED = (fused_lstm_gates, fused_lstm_gates_bwd, fused_batch_norm_leaky_relu)
WARMUP_CALLS = 2


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of tensors, lists, tuples, dataclasses and
    ``None``, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in leaves(item)]
    if tree is None:
        return []
    raise TypeError(f"a program's outputs hold tensors, not {type(tree).__name__}")


def copied(tree):
    """``tree`` with every tensor cloned: outputs that no later call
    overwrites, as a fresh JAX array is."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: copied(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(copied(item) for item in tree)
    return tree


def _counts() -> List[int]:
    return [f.launches for f in COUNTED]


def _set_counts(counts: Sequence[int]) -> None:
    for f, count in zip(COUNTED, counts):
        f.launches = count


class CudaGraph:
    """One ``torch.cuda.CUDAGraph``, warmed up and captured on a side stream
    of its own into a private memory pool, replayed on the current stream."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.graph = torch.cuda.CUDAGraph()
        self.outputs = None

    def warm_up(self, call: Callable[[], object], times: int) -> None:
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            for _ in range(times):
                call()
        current.wait_stream(self.stream)

    def capture(self, run: Callable[[], object],
                generators: Sequence[torch.Generator]) -> None:
        for generator in generators:
            self.graph.register_generator_state(generator)
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            # thread_local: the loader's threads may run while this one records.
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = run()
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass  # the capture is invalid; the first error is the one to raise
                raise
            self.graph.capture_end()
        current.wait_stream(self.stream)
        self.outputs = outputs

    def replay(self) -> None:
        self.graph.replay()


class StandIn:
    """The CPU tests' stand-in for ``CudaGraph``: the warm-up runs as the
    graph's does, the capture records nothing, and a replay calls the
    recorded ``run`` on the static buffers, copying its outputs into the
    first replay's, which stay the static outputs."""

    def __init__(self, device: torch.device):
        self.outputs = None
        self._run = None

    def warm_up(self, call: Callable[[], object], times: int) -> None:
        for _ in range(times):
            call()

    def capture(self, run: Callable[[], object],
                generators: Sequence[torch.Generator]) -> None:
        self._run = run

    def replay(self) -> None:
        results = self._run()
        if self.outputs is None:
            self.outputs = results
            return
        for static, result in zip(leaves(self.outputs), leaves(results)):
            static.copy_(result)


def backend_for(device: torch.device) -> Optional[type]:
    """``CudaGraph`` on a CUDA device; ``None`` (eager) on the CPU."""
    return CudaGraph if torch.device(device).type == "cuda" else None


class Program:
    """``fn`` captured on the static ``state`` and ``inputs`` with
    ``backend`` (``CudaGraph``, or ``StandIn`` in the CPU tests); calling
    it replays.  ``model`` is the module ``fn`` runs, watched for weight
    updates; ``generators`` those ``fn`` draws from.  ``captures`` counts
    the captures."""

    def __init__(self, fn: Callable, state: Sequence[torch.Tensor],
                 inputs: Sequence[torch.Tensor], model: nn.Module, backend: type,
                 generators: Sequence[torch.Generator] = ()):
        self.fn = fn
        self.state = list(state)
        self.inputs = list(inputs)
        self.model = model
        self.generators = tuple(generators)
        self.captures = 0
        self._backend_type = backend
        self._capture()

    def _run(self):
        new_state, outputs = self.fn(*self.state, *self.inputs)
        for static, value in zip(self.state, new_state):
            static.copy_(value)
        return outputs

    def _versions(self) -> List[int]:
        return [t._version for t in self._watched]

    def _require_evaluation_mode(self) -> None:
        if self.model.training:
            raise RuntimeError("a captured route runs the model in evaluation mode; "
                               "call model.eval() first")

    def _capture(self) -> None:
        self._require_evaluation_mode()
        device = next(itertools.chain(self.state, self.inputs)).device
        self._backend = None  # the previous graph and its pool go first
        backend = self._backend_type(device)
        counts = _counts()
        generator_states = [g.get_state() for g in self.generators]
        backend.warm_up(lambda: self.fn(*self.state, *self.inputs), WARMUP_CALLS)
        for generator, saved in zip(self.generators, generator_states):
            generator.set_state(saved)
        _set_counts(counts)
        backend.capture(self._run, self.generators)
        self._delta = [after - before for after, before in zip(_counts(), counts)]
        _set_counts(counts)
        self._watched = list(itertools.chain(self.model.parameters(), self.model.buffers()))
        self._captured_versions = self._versions()
        self._backend = backend
        self.captures += 1

    def __call__(self, *values: torch.Tensor):
        """Copies ``values`` into the static inputs and replays; returns the
        static outputs, which the next call overwrites."""
        self._require_evaluation_mode()
        if self._versions() != self._captured_versions:
            self._capture()
        for static, value in zip(self.inputs, values):
            static.copy_(value)
        self._backend.replay()
        for f, delta in zip(COUNTED, self._delta):
            f.launches += delta
        return self._backend.outputs
