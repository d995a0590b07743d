"""Checkpoint files.

Counterpart of ``playablevideogeneration_tpu/utils/checkpoint.py``.  A
checkpoint is a directory, as orbax's is, so ``checkpoint_exists`` reads
the same in both packages; it holds one ``torch.save`` file of the
training state (``TrainState.state_dict()``: the model's parameters and
buffers, Adam, the learning-rate schedule, the smooth-MI matrix and the
step).  The file is written under a temporary name and renamed into place,
so an interrupted save leaves the previous checkpoint whole.
"""
from __future__ import annotations

import os

import torch

STATE_FILE = "state.pt"


def save_checkpoint(path: str, state_dict: dict) -> None:
    """Writes ``state_dict`` into the checkpoint directory ``path``."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, STATE_FILE)
    tmp = f"{target}.{os.getpid()}.tmp"
    try:
        torch.save(state_dict, tmp)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def restore_checkpoint(path: str) -> dict:
    """The state dict saved in the checkpoint directory ``path``, on the
    CPU.  The loaders copy each tensor to its place: ``load_state_dict`` of
    a module into its device's tensors, of the optimizer onto each
    parameter's device.  Loaded onto the card instead, Adam's step counts
    would stay there, and Adam reads a step count that lies on the card with
    one synchronisation per parameter."""
    file = os.path.join(path, STATE_FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"No checkpoint found at '{path}'")
    return torch.load(file, map_location="cpu")


def checkpoint_exists(path: str) -> bool:
    return os.path.isdir(os.path.abspath(path))
