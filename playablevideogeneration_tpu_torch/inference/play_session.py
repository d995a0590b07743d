"""Interactive inference session with device-resident state.

Counterpart of ``playablevideogeneration_tpu/inference/play_session.py``.
The ConvLSTM carries and the sliding observation window stay on the
model's device between steps; frames come back to the host only when a
method returns them.  A scripted ``rollout`` keeps every frame on the
device as uint8 and reads them back in one transfer at the end.
"""
from __future__ import annotations

import numpy as np
import torch

from playablevideogeneration_tpu_torch.models.caddy import Caddy


def _to_uint8(frame: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 on the frame's device, in the frame's dtype."""
    return ((frame.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)


class PlaySession:
    """Plays the model one action at a time from an initial observation.

    With ``noise=True`` each step draws its action variation from N(0, 1)
    with a ``torch.Generator`` on the model's device seeded with ``seed``;
    otherwise the variation is zero.
    """

    def __init__(self, model: Caddy, noise: bool = False, seed: int = 0):
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

    def start(self, observation: np.ndarray) -> "PlaySession":
        """Begins a session from an initial stacked observation
        (H, W, 3*stacking) in [-1, 1]."""
        self.carry = self.model.init_play(1)
        self.window = torch.as_tensor(np.asarray(observation))[None].to(
            self.device, self.model.dtype)
        return self

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

    def _step(self, onehot: torch.Tensor, variation: torch.Tensor) -> torch.Tensor:
        self.carry, frame, self.window = self.model.play_step(
            self.carry, self.window, onehot, variation)
        return frame

    def generate_next(self, action: int) -> np.ndarray:
        """One interactive step; returns the (H, W, 3) frame in [-1, 1] as
        float32 (numpy has no bfloat16)."""
        frame = self._step(self._onehot(action), self._variations(1))
        return frame[0].float().cpu().numpy()

    def generate_next_u8(self, action: int, block: bool = True):
        """One interactive step returning a display-ready (H, W, 3) uint8
        frame, converted on the device.  With ``block=False`` the device
        tensor is returned, so its readback can overlap the next step."""
        frame = _to_uint8(self._step(self._onehot(action), self._variations(1))[0])
        return frame.cpu().numpy() if block else frame

    def generate_next_interpolation(self, first_action: int, second_action: int,
                                    interpolation_factor: float) -> np.ndarray:
        """Action interpolation: the variation moves the selected action's
        centroid along the line between the two actions' centroids."""
        centroids = self.model.centroids
        selected = second_action if interpolation_factor > 0.5 else first_action
        first_c, second_c = centroids[first_action], centroids[second_action]
        interpolated = (second_c - first_c) * interpolation_factor + first_c
        variation = (interpolated - centroids[selected])[None]
        frame = self._step(self._onehot(selected), variation)
        return frame[0].float().cpu().numpy()

    def rollout(self, actions: np.ndarray) -> np.ndarray:
        """Scripted rollout of N actions; returns (N, H, W, 3) uint8 frames
        read back in one transfer.  Honors the session's ``noise`` flag
        as the interactive path does."""
        onehots = [self._onehot(action) for action in actions]
        variations = self._variations(len(onehots))
        frames = torch.stack([
            _to_uint8(self._step(onehot, variations[i:i + 1])[0])
            for i, onehot in enumerate(onehots)])
        return frames.cpu().numpy()


def frame_to_uint8(frame: np.ndarray) -> np.ndarray:
    """[-1, 1] float frame -> uint8 RGB (no-op for already-uint8 frames
    produced by the device-side conversion paths)."""
    frame = np.asarray(frame)
    if frame.dtype == np.uint8:
        return frame
    return ((np.clip(frame, -1.0, 1.0) + 1.0) * 127.5).astype(np.uint8)
