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

A ``TrainProgram`` is the training step's counterpart of the JAX
trainer's ``jax.jit(train_step)``: ``fn`` runs the model in training mode,
forward and backward, and the graph holds both.  It differs from a
``Program`` where training writes state:

- The gradients are static outputs.  Each recording starts with every
  parameter's ``.grad`` at ``None``, so that the backward allocates them in
  the graph's pool; a replay rewrites them in place, and the caller's
  optimizer, which runs outside the graph, reads them there.
- The warm-up runs whole steps, which fold the BatchNorm statistics and
  the centroids and draw noise: every buffer of the model, the static state
  and the generators are saved before it and restored after it.
- A replay writes the BatchNorm statistics and the centroids in place
  without advancing their version counters, which ``Program`` (and the
  cached weight casts of ``models.layers._CastParameters``) rely on to see
  an update; so every replay advances the counter of each buffer of the
  model, as an eager step's in-place writes do.
- The parameters move at every step, outside the graph, which reads them
  where they lie and casts them inside itself: their versions are not
  watched.

A ``ProgramCache`` keeps one program per key, the least recently used
evicted first, as ``jax.jit`` keeps one trace per shape: a new shape, or
a new TF32 setting (``tf32_flags``: a graph replays the kernels and math
modes chosen when it recorded), is a new key.  ``replayed`` makes a
stateless function of host tensors, the offline evaluation's backbones
and metrics, into such programs.

``CudaGraph`` records and replays.  ``StandIn``, the one test seam, calls
``fn`` on the same static buffers where the graph would replay, so that
the CPU tests hold the buffer handling; ``backend_for`` never chooses it.
``Eager`` names the other seam, a route run op by op on any device
(``resolve_backend``).  A capture that fails raises: there is no eager
fallback on the card.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Callable, Hashable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from playablevideogeneration_tpu_torch.ops.cuda.convlstm_gates import (
    fused_lstm_gates,
    fused_lstm_gates_bwd,
)
from playablevideogeneration_tpu_torch.ops.cuda.fused_norm_act import (
    fused_batch_norm_leaky_relu,
)
from playablevideogeneration_tpu_torch.ops.cuda.nms_sweep import nms_keep

# The kernel wrappers whose ``launches`` a program keeps.
COUNTED = (fused_lstm_gates, fused_lstm_gates_bwd, fused_batch_norm_leaky_relu, nms_keep)
WARMUP_CALLS = 2
# The programs a ``ProgramCache`` keeps, as the JAX evaluator keeps its
# jitted forwards.
PROGRAMS = 6


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of tensors, lists, tuples, dicts, dataclasses
    and ``None``, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
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
    if isinstance(tree, dict):
        return {key: copied(value) for key, value in tree.items()}
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
        # The warm-up's freed blocks stay cached for its stream, and the
        # allocator cannot hand cached memory back to the device while a
        # capture runs: a training step's capture would find the card full.
        torch.cuda.synchronize(self.stream.device)
        torch.cuda.empty_cache()
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


class Eager:
    """The seam's other choice: the route runs op by op on any device.  The
    step profiler, whose scopes are module hooks that a replay does not
    fire, and the chip check's eager comparisons pass it."""


def backend_for(device: torch.device) -> Optional[type]:
    """``CudaGraph`` on a CUDA device; ``None`` (eager) on the CPU."""
    return CudaGraph if torch.device(device).type == "cuda" else None


def tf32_flags() -> Tuple[bool, bool]:
    """cuDNN's and cuBLAS's TF32 switches, part of the key of a program
    that runs f32 convolutions or products: a graph recorded with TF32 on
    must not replay once it is off, nor the other way round."""
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def resolve_backend(device: torch.device, backend: Optional[type]) -> Optional[type]:
    """The backend a route on ``device`` uses: ``backend_for(device)`` when
    the caller names none, ``None`` (eager) for ``Eager``, else
    ``backend``."""
    if backend is None:
        return backend_for(device)
    return None if backend is Eager else backend


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

    def _require_mode(self) -> None:
        if self.model.training:
            raise RuntimeError("a captured route runs the model in evaluation mode; "
                               "call model.eval() first")

    def _save(self) -> Callable[[], None]:
        """Saves what the warm-up may move; returns what restores it."""
        generator_states = [g.get_state() for g in self.generators]

        def restore():
            for generator, saved in zip(self.generators, generator_states):
                generator.set_state(saved)
        return restore

    def _stale(self) -> bool:
        return self._versions() != self._captured_versions

    def _capture(self) -> None:
        self._require_mode()
        device = next(itertools.chain(self.state, self.inputs)).device
        self._backend = None  # the previous graph and its pool go first
        backend = self._backend_type(device)
        counts = _counts()
        restore = self._save()
        backend.warm_up(lambda: self.fn(*self.state, *self.inputs), WARMUP_CALLS)
        restore()
        _set_counts(counts)
        backend.capture(self._run, self.generators)
        self._delta = [after - before for after, before in zip(_counts(), counts)]
        _set_counts(counts)
        self._watched = list(itertools.chain(self.model.parameters(), self.model.buffers()))
        self._captured_versions = self._versions()
        self._backend = backend
        self.captures += 1

    def _replayed(self) -> None:
        """What follows a replay: the launch counters moved as an eager call
        moves them."""
        for f, delta in zip(COUNTED, self._delta):
            f.launches += delta

    def __call__(self, *values: torch.Tensor):
        """Copies ``values`` into the static inputs and replays; returns the
        static outputs, which the next call overwrites."""
        self._require_mode()
        if self._stale():
            self._capture()
        for static, value in zip(self.inputs, values):
            static.copy_(value)
        self._backend.replay()
        self._replayed()
        return self._backend.outputs


class TrainProgram(Program):
    """A training step captured with the model in training mode: ``fn(*state,
    *inputs)`` returns ``(new_state, outputs)`` as a ``Program``'s does, and
    runs the backward, whose gradients it returns among its outputs (the
    static gradients, which the caller points the parameters' ``.grad``
    at).  See the module docstring for what it adds to ``Program``."""

    def _require_mode(self) -> None:
        if not self.model.training:
            raise RuntimeError("a captured training step runs the model in training mode; "
                               "call model.train() first")

    def _save(self) -> Callable[[], None]:
        restore_generators = super()._save()
        tensors = list(itertools.chain(self.model.buffers(), self.state))
        saved = [t.detach().clone() for t in tensors]

        def restore():
            restore_generators()
            with torch.no_grad():
                for tensor, value in zip(tensors, saved):
                    tensor.copy_(value)
            for p in self.model.parameters():
                p.grad = None
        return restore

    def _stale(self) -> bool:
        return False

    def _run(self):
        for p in self.model.parameters():
            p.grad = None  # the backward allocates them: in the graph's pool
        return super()._run()

    def _replayed(self) -> None:
        super()._replayed()
        torch.autograd.graph.increment_version(list(self.model.buffers()))


class ProgramCache(collections.OrderedDict):
    """Programs by key, the least recently used first; at most ``size``
    (``PROGRAMS``) are kept."""

    def __init__(self, size: int = PROGRAMS):
        super().__init__()
        self.size = size

    def program(self, key: Hashable, make: Callable[[], Program],
                current: Callable[[Program], bool] = lambda program: True) -> Program:
        """The program of ``key`` if there is one and ``current`` holds for
        it, else ``make()``'s, which takes its place; the least recently
        used programs go first when the cache is full.  No reference to a
        program that goes is left while the new one records: its graph and
        pool are freed first."""
        program = self.get(key)
        if program is not None and current(program):
            self.move_to_end(key)
            return program
        program = None
        self.pop(key, None)
        while len(self) >= self.size:
            self.popitem(last=False)
        self[key] = make()
        return self[key]


def to_numpy(tensor: torch.Tensor):
    """``tensor`` read into a numpy array of its own: a program's static
    output is overwritten by the next call, and on the CPU ``.numpy()``
    would share its memory."""
    return tensor.detach().to("cpu", copy=True).numpy()


def replayed(fn: Callable, model: nn.Module, device: torch.device,
             backend: Optional[type] = None) -> Callable:
    """``fn(*inputs)``, pure, of tensors on ``device`` (a tensor or a tree
    of them out; ``model`` the module it runs, watched for weight
    updates), as a function of host tensors.  Without a backend
    (``resolve_backend``: the CPU, or ``Eager``) it copies each input to
    ``device`` and runs ``fn`` op by op; else it replays the ``Program`` of
    the inputs' shapes and ``tf32_flags()`` from a ``ProgramCache`` (the
    returned function's ``programs``), each input copied once into its
    static input.  The outputs are then the static ones, which the next
    call overwrites: read them first.  ``fn`` must not hold the owner of
    the returned function (a weak reference does).  ``to_numpy`` reads an
    output."""
    device = torch.device(device)
    graphed = resolve_backend(device, backend)
    programs = ProgramCache()

    def call(*values: torch.Tensor):
        if graphed is None:
            return fn(*(v.to(device) for v in values))
        key = (tuple(tuple(v.shape) for v in values), *tf32_flags())
        program = programs.program(key, lambda: Program(
            lambda *inputs: ((), fn(*inputs)), (),
            [torch.zeros(v.shape, dtype=v.dtype, device=device) for v in values], model,
            graphed))
        return program(*values)

    call.programs = programs
    return call
