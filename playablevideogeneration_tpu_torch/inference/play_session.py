"""Interactive inference session with device-resident state.

Counterpart of ``playablevideogeneration_tpu/inference/play_session.py``.
The ConvLSTM carries and the sliding observation window stay on the
model's device between steps; frames come back to the host only when a
method returns them.  A scripted ``rollout`` keeps every frame on the
device as uint8 and reads them back in one transfer at the end.

On a CUDA device each step and each rollout is one replay of a captured
program (``inference.graphs``), the counterpart of the JAX session's
``jax.jit`` step and ``lax.scan`` rollout: the interactive step's graph
emits the frame and its uint8 copy, so that ``generate_next``,
``generate_next_u8`` and ``generate_next_interpolation`` share it, and
the rollout of N actions is one graph per N, captured at its first use.
The carries and the window are the session's own static buffers, which
``start`` refills in place; the one-hot rows and the variations are
copied into static inputs before each replay, the noise drawn outside the
graph from the session's generator, as the JAX session draws it outside
``jit``.  On the CPU the session runs eagerly.

Each call of a method that returns frames is the span ``play.call``, and
the frames' copy to the host inside it ``play.readback``
(``utils.tracing``).
"""
from __future__ import annotations

import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

from playablevideogeneration_tpu_torch.inference import graphs
from playablevideogeneration_tpu_torch.models.caddy import Caddy
from playablevideogeneration_tpu_torch.utils import tracing

_CALL = tracing.span("play.call")
_READBACK = tracing.span("play.readback")


def _to_uint8(frame: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 on the frame's device, in the frame's dtype."""
    return ((frame.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)


def _to_host(tensor: torch.Tensor) -> np.ndarray:
    """A numpy copy that no later step overwrites, on any device."""
    with _READBACK:
        return tensor.to("cpu", copy=True).numpy()


class PlaySession:
    """Plays the model one action at a time from an initial observation.

    With ``noise=True`` each step draws its action variation from N(0, 1)
    with a ``torch.Generator`` on the model's device seeded with ``seed``;
    otherwise the variation is zero.  ``backend`` is for the CPU tests
    only (``graphs.StandIn``); by default the device decides.
    """

    def __init__(self, model: Caddy, noise: bool = False, seed: int = 0,
                 backend: Optional[type] = None):
        self.model = model
        self.actions_count = model.actions_count
        self.action_space_dimension = model.action_space_dimension
        self.noise = noise
        self.device = model.centroids.device
        self.carry = None
        self.window = None
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        # One-hot rows are slices of this matrix, so a step uploads nothing.
        self._eye = torch.eye(self.actions_count, device=self.device)
        self._backend = graphs.resolve_backend(self.device, backend)
        # "step" and ("rollout", N) -> graphs.Program
        self._programs = {}

    def start(self, observation: np.ndarray) -> "PlaySession":
        """Begins a session from an initial stacked observation
        (H, W, 3*stacking) in [-1, 1]."""
        window = torch.as_tensor(np.asarray(observation))[None].to(
            self.device, self.model.dtype)
        if self._backend is None:
            self.carry, self.window = self.model.init_play(1), window
            return self
        if self.window is None or self.window.shape != window.shape:
            # New static buffers: the window in NHWC storage, the model's
            # channels-last storage, as the steps return it.
            self.carry = self.model.init_play(1)
            self.window = torch.empty_like(window)
            self._programs = {}
        else:
            for static, initial in zip(self._state()[:-1],
                                       [t for hc in self.model.init_play(1) for t in hc]):
                static.copy_(initial)
        self.window.copy_(window)
        return self

    def _state(self) -> List[torch.Tensor]:
        return [t for hc in self.carry for t in hc] + [self.window]

    def _variations(self, count: int) -> torch.Tensor:
        shape = (count, self.action_space_dimension)
        if self.noise:
            return torch.randn(shape, generator=self._generator, device=self.device)
        return torch.zeros(shape, device=self.device)

    def _onehot(self, action: int) -> torch.Tensor:
        """(1, actions_count) one-hot row on the device."""
        action = int(action)
        if not 0 <= action < self.actions_count:
            raise ValueError(f"action must lie in [0, {self.actions_count}), got {action}")
        return self._eye[action:action + 1]

    def _advance(self, state: Sequence[torch.Tensor], onehot: torch.Tensor,
                 variation: torch.Tensor):
        """One play step on the flat state (h, c of each ConvLSTM, the
        window): (new state, the frame (H, W, 3) in the model dtype)."""
        carry = tuple((state[i], state[i + 1]) for i in range(0, 6, 2))
        carry, frame, window = self.model.play_step(carry, state[6], onehot, variation)
        return [t for hc in carry for t in hc] + [window], frame[0]

    def _step(self, *tensors: torch.Tensor):
        *state, onehot, variation = tensors
        state, frame = self._advance(state, onehot, variation)
        return state, (frame.float(), _to_uint8(frame))

    def _rollout(self, *tensors: torch.Tensor):
        *state, onehots, variations = tensors
        frames = []
        for i in range(onehots.shape[0]):
            state, frame = self._advance(state, onehots[i:i + 1], variations[i:i + 1])
            frames.append(_to_uint8(frame))
        return state, torch.stack(frames)

    def _call(self, key, fn, *values: torch.Tensor):
        """``fn`` over the session's state and ``values``: eagerly on the
        CPU, else by replaying its program, captured at the first call."""
        if self._backend is None:
            state, outputs = fn(*self._state(), *values)
            self.carry = tuple((state[i], state[i + 1]) for i in range(0, 6, 2))
            self.window = state[6]
            return outputs
        program = self._programs.get(key)
        if program is None:
            method = weakref.WeakMethod(fn)  # the program must not hold the session
            program = self._programs[key] = graphs.Program(
                lambda *tensors: method()(*tensors), self._state(),
                [v.clone() for v in values], self.model, self._backend)
        return program(*values)

    def generate_next(self, action: int) -> np.ndarray:
        """One interactive step; returns the (H, W, 3) frame in [-1, 1] as
        float32 (numpy has no bfloat16)."""
        with _CALL:
            frame, _ = self._call("step", self._step, self._onehot(action),
                                  self._variations(1))
            return _to_host(frame)

    def generate_next_u8(self, action: int, block: bool = True):
        """One interactive step returning a display-ready (H, W, 3) uint8
        frame, converted on the device.  With ``block=False`` a device
        tensor of its own is returned, so its readback can overlap the
        next step."""
        with _CALL:
            _, frame = self._call("step", self._step, self._onehot(action),
                                  self._variations(1))
            return _to_host(frame) if block else frame.clone()

    def generate_next_interpolation(self, first_action: int, second_action: int,
                                    interpolation_factor: float) -> np.ndarray:
        """Action interpolation: the variation moves the selected action's
        centroid along the line between the two actions' centroids."""
        with _CALL:
            centroids = self.model.centroids
            selected = second_action if interpolation_factor > 0.5 else first_action
            first_c, second_c = centroids[first_action], centroids[second_action]
            interpolated = (second_c - first_c) * interpolation_factor + first_c
            variation = (interpolated - centroids[selected])[None]
            frame, _ = self._call("step", self._step, self._onehot(selected), variation)
            return _to_host(frame)

    def rollout(self, actions: np.ndarray) -> np.ndarray:
        """Scripted rollout of N actions; returns (N, H, W, 3) uint8 frames
        read back in one transfer.  Honors the session's ``noise`` flag
        as the interactive path does."""
        with _CALL:
            onehots = torch.cat([self._onehot(action) for action in actions])
            frames = self._call(("rollout", len(onehots)), self._rollout, onehots,
                                self._variations(len(onehots)))
            return _to_host(frames)


def frame_to_uint8(frame: np.ndarray) -> np.ndarray:
    """[-1, 1] float frame -> uint8 RGB (no-op for already-uint8 frames
    produced by the device-side conversion paths)."""
    frame = np.asarray(frame)
    if frame.dtype == np.uint8:
        return frame
    return ((np.clip(frame, -1.0, 1.0) + 1.0) * 127.5).astype(np.uint8)
