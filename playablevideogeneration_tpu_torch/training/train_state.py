"""Training state.

Counterpart of ``playablevideogeneration_tpu/training/train_state.py``.
The JAX state is an immutable pytree; here the parameters, the BatchNorm
statistics and the centroids live in the model (parameters and buffers)
and are updated in place, the Adam moments in the optimizer, and the
smooth-MI joint matrix and the step beside them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from playablevideogeneration_tpu_torch.models import layers
from playablevideogeneration_tpu_torch.models.caddy import Caddy

# Adam's per-parameter tensors of a parameter's shape.
_MOMENTS = ("exp_avg", "exp_avg_sq")


@dataclass
class TrainState:
    model: Caddy  # parameters, BatchNorm statistics, centroids
    optimizer: torch.optim.Adam  # Adam moments and step counts
    scheduler: torch.optim.lr_scheduler.MultiStepLR
    mi_matrix: torch.Tensor  # (A, A) f32 smooth-MI joint matrix estimate
    step: int = 0  # optimizer steps taken

    def state_dict(self) -> dict:
        """Everything a checkpoint holds, in full tensors: every rank of a
        model group that holds sharded layers must call it (one gather per
        sharded tensor)."""
        return self._map_sharded(
            dict(model=self.model.state_dict(), optimizer=self.optimizer.state_dict(),
                 scheduler=self.scheduler.state_dict(), mi_matrix=self.mi_matrix,
                 step=self.step), layers.ColumnParallel.gather)

    def load_state_dict(self, state: dict) -> None:
        """Restores what ``state_dict`` saved, in place: the parameters and
        buffers (BatchNorm statistics, centroids), Adam's moments and step
        counts, the schedule, the MI matrix and the step; of a sharded
        parameter and its moments, this rank's slice."""
        state = self._map_sharded(state, layers.ColumnParallel.slice)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.mi_matrix = state["mi_matrix"].to(self.mi_matrix.device)
        self.step = int(state["step"])

    def _map_sharded(self, state: dict, method: Callable) -> dict:
        """``state`` with each sharded parameter's tensor and Adam moments
        passed through ``method`` of its layer (``ColumnParallel.gather``
        or ``slice``); the other entries shared with ``state``, which is
        left as it is."""
        sharded = layers.sharded_layers(self.model)
        if not sharded:
            return state
        params = [p for group in self.optimizer.param_groups for p in group["params"]]
        index = {id(p): i for i, p in enumerate(params)}
        model, slots = dict(state["model"]), dict(state["optimizer"]["state"])
        for name, layer in sharded.items():
            model[name] = method(layer, model[name])
            i = index[id(layer.weight)]
            if i in slots:
                slots[i] = dict(slots[i], **{k: method(layer, slots[i][k]) for k in _MOMENTS})
        return dict(state, model=model, optimizer=dict(state["optimizer"], state=slots))
