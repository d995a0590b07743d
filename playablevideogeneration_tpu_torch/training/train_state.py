"""Training state.

Counterpart of ``playablevideogeneration_tpu/training/train_state.py``.
The JAX state is an immutable pytree; here the parameters, the BatchNorm
statistics and the centroids live in the model (parameters and buffers)
and are updated in place, the Adam moments in the optimizer, and the
smooth-MI joint matrix and the step beside them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from playablevideogeneration_tpu_torch.models.caddy import Caddy


@dataclass
class TrainState:
    model: Caddy  # parameters, BatchNorm statistics, centroids
    optimizer: torch.optim.Adam  # Adam moments and step counts
    scheduler: torch.optim.lr_scheduler.MultiStepLR
    mi_matrix: torch.Tensor  # (A, A) f32 smooth-MI joint matrix estimate
    step: int = 0  # optimizer steps taken

    def state_dict(self) -> dict:
        """Everything a checkpoint holds."""
        return dict(model=self.model.state_dict(), optimizer=self.optimizer.state_dict(),
                    scheduler=self.scheduler.state_dict(), mi_matrix=self.mi_matrix,
                    step=self.step)

    def load_state_dict(self, state: dict) -> None:
        """Restores what ``state_dict`` saved, in place: the parameters and
        buffers (BatchNorm statistics, centroids), Adam's moments and step
        counts, the schedule, the MI matrix and the step."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.mi_matrix = state["mi_matrix"].to(self.mi_matrix.device)
        self.step = int(state["step"])
