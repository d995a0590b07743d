"""Trainer: the training step and its host-side schedules.

Counterpart of ``playablevideogeneration_tpu/training/trainer.py``:
``compute_loss_terms`` (forward, the seven weighted loss terms and the
diagnostics) and ``Trainer`` with ``init_state``, the annealing schedules
and ``train_step``.  One step runs the forward and backward on the model's
device, takes one Adam step, and updates the BatchNorm statistics and the
centroids (in the forward, in place) and the smooth-MI matrix; it returns
its metrics with one device-to-host transfer.

The epoch loop over a ``DataLoader``, checkpoint files, gradient
histograms, action-space plots and the profiler window belong to the
train CLI and are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from playablevideogeneration_tpu_torch.models.caddy import Caddy
from playablevideogeneration_tpu_torch.models.centroids import average_centroid_distance
from playablevideogeneration_tpu_torch.models.vgg import Vgg19, make_vgg
from playablevideogeneration_tpu_torch.training import losses, schedules
from playablevideogeneration_tpu_torch.training.train_state import TrainState


def compute_loss_terms(model: Caddy, observations: torch.Tensor, actions: torch.Tensor,
                       gt_init: int, gumbel_temperature: float,
                       generator: torch.Generator, vgg: Vgg19,
                       loss_weights: Dict[str, float], mi_lambda: float, pretraining: bool,
                       use_motion_weights: bool, motion_weights_bias: float,
                       mi_matrix: Optional[torch.Tensor], mi_alpha: Optional[float]
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Forward and every loss term.

    :param observations: (B, T, 3*stacking, H, W) in [-1, 1]
    :param actions: (B, T) ground-truth action indices
    :param mi_matrix: the smooth-MI joint matrix, or None for the plain MI
    :return: (total loss, aux) where aux holds ``new_mi_matrix`` (None for
        the plain MI) and ``info``, the terms and diagnostics (detached)
    """
    out = model(observations, actions, gt_init, generator=generator,
                pretraining=pretraining, gumbel_temperature=gumbel_temperature)
    suffix = "_pretraining" if pretraining else ""
    w = loss_weights

    weight_mask = None
    if use_motion_weights:
        weight_mask = losses.motion_weight_mask(
            observations, out.reconstructed_observations, motion_weights_bias)

    # Reconstruction and perceptual losses, averaged over D's resolutions.
    resolutions = out.multiresolution_reconstructed_observations
    perceptual_total = torch.zeros((), device=observations.device)
    obs_rec_total = torch.zeros((), device=observations.device)
    info: Dict[str, torch.Tensor] = {}
    for r_idx, recon in enumerate(resolutions):
        p_total, p_levels = losses.perceptual_loss(vgg, observations, recon, weight_mask)
        o_loss = losses.observations_loss(observations, recon, weight_mask)
        perceptual_total = perceptual_total + p_total
        obs_rec_total = obs_rec_total + o_loss
        info[f"perceptual_loss_r{r_idx}"] = p_total
        info[f"observations_rec_loss_r{r_idx}"] = o_loss
        for l_idx, level in enumerate(p_levels):
            info[f"perceptual_loss_r{r_idx}_l{l_idx}"] = level
    perceptual_loss = perceptual_total / len(resolutions)
    obs_rec_loss = obs_rec_total / len(resolutions)
    perceptual_term = w[f"perceptual_loss_lambda{suffix}"] * perceptual_loss

    states_rec_loss = losses.states_loss(out.states.detach(), out.reconstructed_states)
    entropy_loss = losses.entropy_logits(out.action_logits)
    directions_kl = losses.kl_gaussian_divergence(out.action_directions_distribution)
    # The reconstructed action-state distribution chases the real one.
    action_state_kl = losses.kl_general_gaussian_divergence(
        out.reconstructed_action_states_distribution,
        out.action_states_distribution.detach())

    p_real = F.softmax(out.action_logits, dim=-1)
    p_recon = F.softmax(out.reconstructed_action_logits, dim=-1)
    new_mi_matrix = None
    if mi_matrix is not None:
        mi_loss, new_mi_matrix = losses.smooth_mutual_information_loss(
            p_real, p_recon, mi_matrix, mi_alpha, lamb=mi_lambda)
    else:
        mi_loss = losses.mutual_information_loss(p_real, p_recon, lamb=mi_lambda)

    total = (w[f"reconstruction_loss_lambda{suffix}"] * obs_rec_loss
             + perceptual_term
             + w[f"states_rec_lambda{suffix}"] * states_rec_loss
             + w[f"entropy_lambda{suffix}"] * entropy_loss
             + w[f"action_directions_kl_lambda{suffix}"] * directions_kl
             + w[f"action_mutual_information_lambda{suffix}"] * mi_loss
             + w[f"action_state_distribution_kl_lambda{suffix}"] * action_state_kl)

    if pretraining:
        # No gradient from the dynamics hidden states into the
        # representation network through the projection target.
        hidden_rec_loss = losses.hidden_states_loss(
            out.hidden_states, out.reconstructed_hidden_states.detach())
        total = total + w["hidden_states_rec_lambda_pretraining"] * hidden_rec_loss
        info["hidden_states_rec_loss"] = hidden_rec_loss

    centroids = model.centroids
    dirs = out.action_directions_distribution
    info.update(
        avg_observations_rec_loss=obs_rec_loss,
        avg_perceptual_loss=perceptual_loss,
        loss_component_perceptual_loss=perceptual_term,
        states_rec_loss=states_rec_loss,
        entropy_loss=entropy_loss,
        samples_entropy=losses.entropy_probabilities(out.action_samples),
        action_distribution_entropy=losses.entropy_probabilities(
            out.action_samples.mean(dim=(0, 1))[None]),
        states_magnitude=torch.mean(torch.abs(out.states)),
        hidden_states_magnitude=torch.mean(torch.abs(out.hidden_states)),
        action_directions_mean_magnitude=torch.mean(torch.abs(dirs[:, :, 0])),
        action_directions_variance_magnitude=torch.mean(torch.abs(dirs[:, :, 1])),
        action_directions_reconstruction_error=torch.mean(
            (out.reconstructed_action_directions_distribution[:, :, 0] - dirs[:, :, 0]) ** 2),
        action_directions_kl_loss=directions_kl,
        centroids_mean_magnitude=torch.mean(torch.abs(centroids)),
        average_centroids_distance=average_centroid_distance(centroids),
        average_action_variations_norm_l2=torch.mean(
            torch.sqrt(torch.sum(out.action_variations ** 2, dim=-1) + 1e-12)),
        action_variations_mean=torch.mean(out.action_variations),
        action_mutual_information_loss=mi_loss,
        action_state_distribution_kl_loss=action_state_kl,
        # Categorical KL of the reconstructed from the real action
        # distribution: a diagnostic, never weighted into the total.
        actions_kl_divergence=losses.kl_divergence_categorical(
            out.reconstructed_action_logits, out.action_logits),
    )
    info = {k: v.detach() for k, v in info.items()}
    return total, dict(new_mi_matrix=new_mi_matrix, info=info)


class Trainer:
    """Training of one model on its device.

    :param vgg: the perceptual loss's frozen VGG19; by default a seeded one
        (``models.vgg.make_vgg``) in the model's dtype
    :param seed: seeds the noise generator (on the model's device) and the
        default VGG
    """

    def __init__(self, config: dict, model: Caddy, smooth_mi: bool = False,
                 vgg: Optional[Vgg19] = None, seed: int = 0):
        self.config = config
        self.model = model
        self.smooth_mi = smooth_mi
        self.device = model.centroids.device
        self.vgg = vgg if vgg is not None else make_vgg(self.device, model.dtype, seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.global_step = 0
        self.state: Optional[TrainState] = None
        t = config["training"]
        self._loss_kwargs = dict(
            loss_weights=dict(t["loss_weights"]),
            mi_lambda=t.get("action_mutual_information_entropy_lambda", 1.0),
            use_motion_weights=t.get("use_motion_weights", False),
            motion_weights_bias=t.get("motion_weights_bias", 0.0),
            mi_alpha=t.get("mutual_information_estimation_alpha", 0.2) if smooth_mi else None)

    def init_state(self) -> TrainState:
        """Puts the model in training mode and builds the optimizer, the
        learning-rate schedule and the uniform MI matrix."""
        self.model.train()
        optimizer, scheduler = schedules.make_optimizer(self.config, self.model.parameters())
        self.state = TrainState(
            model=self.model, optimizer=optimizer, scheduler=scheduler,
            mi_matrix=losses.init_mi_matrix(self.config["data"]["actions_count"],
                                            self.device))
        return self.state

    # Host-side schedules of the global step.

    def get_ground_truth_observations_count(self) -> int:
        t = self.config["training"]
        return schedules.ground_truth_observations_count(
            self.global_step, t["ground_truth_observations_start"],
            t["ground_truth_observations_end"], t["ground_truth_observations_steps"])

    def get_gumbel_temperature(self) -> float:
        t = self.config["training"]
        return schedules.gumbel_temperature(
            self.global_step, t["gumbel_temperature_start"], t["gumbel_temperature_end"],
            t["gumbel_temperature_steps"])

    def get_observations_count(self) -> int:
        b = self.config["training"]["batching"]
        return schedules.observations_count(
            self.global_step, b["observations_count_start"], b["observations_count"],
            b["observations_count_steps"])

    def train_step(self, batch) -> Dict[str, float]:
        """One optimizer step on ``batch`` (``observations`` (B, T, H, W,
        3*stacking) in [-1, 1], channels last as the loader gives them, and
        ``actions`` (B, T); numpy arrays or tensors).  The phase is
        pretraining for the first ``pretraining_steps`` steps.

        :return: the loss, its terms and diagnostics, the global and
            per-subnetwork gradient norms, and the schedules' values
        """
        if self.state is None:
            raise RuntimeError("call init_state first")
        state = self.state
        self.global_step += 1
        observations = torch.as_tensor(batch.observations, device=self.device)
        observations = observations.float().permute(0, 1, 4, 2, 3).contiguous()
        actions = torch.as_tensor(batch.actions, device=self.device)
        t = observations.shape[1]
        pretraining = self.global_step <= self.config["training"]["pretraining_steps"]
        gt_init = min(self.get_ground_truth_observations_count(), t - 1)
        gumbel_t = self.get_gumbel_temperature()
        lr = state.scheduler.get_last_lr()[0]

        state.optimizer.zero_grad(set_to_none=True)
        total, aux = compute_loss_terms(
            self.model, observations, actions, gt_init, gumbel_t, self.generator, self.vgg,
            pretraining=pretraining, mi_matrix=state.mi_matrix if self.smooth_mi else None,
            **self._loss_kwargs)
        total.backward()

        # A parameter the phase does not use (state_to_hidden in the full
        # phase) takes a zero gradient, so that Adam decays it as optax does.
        modules: Dict[str, list] = {}
        for name, p in self.model.named_parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            modules.setdefault(name.split(".")[0], []).append(p.grad)
        squares = {m: torch.stack(torch._foreach_norm(g)).square().sum()
                   for m, g in modules.items()}
        state.optimizer.step()
        state.scheduler.step()
        if self.smooth_mi:
            state.mi_matrix = aux["new_mi_matrix"]
        state.step += 1

        metrics = dict(aux["info"])
        metrics["loss"] = total.detach()
        metrics["grad_norm/global"] = torch.sqrt(sum(squares.values()))
        for m, sq in squares.items():
            metrics[f"grad_norm/{m}"] = torch.sqrt(sq)
        values = torch.stack([v.float() for v in metrics.values()]).tolist()
        metrics = dict(zip(metrics, values))
        metrics.update(ground_truth_observations=gt_init, gumbel_temperature=gumbel_t,
                       observations_count=t, lr=lr, pretraining=float(pretraining))
        return metrics
