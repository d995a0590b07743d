"""Trainer: the training step, the epoch loop and checkpoints.

Counterpart of ``playablevideogeneration_tpu/training/trainer.py``:
``compute_loss_terms`` (forward, the seven weighted loss terms and the
diagnostics) and ``Trainer``.  ``train_step`` runs one step's forward and
backward on the model's device, takes one Adam step, and updates the
BatchNorm statistics and the centroids (in the forward, in place) and the
smooth-MI matrix; it returns its metrics with one device-to-host transfer.
``train_epoch`` drives it over the ``DataLoader``'s batches with the
annealing schedules, logging, the optional gradient histograms, profiler
window and action-space plots; ``save_checkpoint`` and ``load_checkpoint``
write and read the training state, and ``load_reference_weights`` imports
a reference ``.pth.tar``'s weights.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from playablevideogeneration_tpu_torch.data.loader import DataLoader
from playablevideogeneration_tpu_torch.models.caddy import Caddy
from playablevideogeneration_tpu_torch.models.centroids import average_centroid_distance
from playablevideogeneration_tpu_torch.models.vgg import Vgg19, make_vgg
from playablevideogeneration_tpu_torch.training import losses, schedules
from playablevideogeneration_tpu_torch.training.train_state import TrainState
from playablevideogeneration_tpu_torch.utils import checkpoint as ckpt_lib
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables
from playablevideogeneration_tpu_torch.utils.logging import AverageMeter, Logger
from playablevideogeneration_tpu_torch.utils.reference_checkpoint import (
    load_reference_checkpoint,
)
from playablevideogeneration_tpu_torch.utils.tensor_ops import sequence_to_nchw

# Metrics of train_step that train_epoch prints every step.
_PRINTED = ("loss", "avg_observations_rec_loss", "avg_perceptual_loss", "states_rec_loss",
            "action_mutual_information_loss", "step_time")


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
        the plain MI), ``info``, the terms and diagnostics, and
        ``plot_arrays``, the action-space plots' inputs (all detached)
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
    # The action-space plots' inputs: a few KB, left on the device.
    plot_arrays = dict(action_directions_distribution=dirs.detach(),
                       action_probabilities=p_real.detach(),
                       action_states_distribution=out.action_states_distribution.detach(),
                       centroids=centroids.clone())
    return total, dict(new_mi_matrix=new_mi_matrix, info=info, plot_arrays=plot_arrays)


def _histogram(values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """64-bin (counts, edges) of ``values`` on their device, as
    ``np.histogram`` returns them; all-equal values still get distinct
    edges."""
    lo, hi = values.min(), values.max()
    hi = torch.where(hi <= lo, lo + 1e-12, hi)
    edges = lo + (hi - lo) * torch.linspace(0.0, 1.0, 65, device=values.device)
    index = (torch.searchsorted(edges, values, right=True) - 1).clamp(0, 63)
    return torch.bincount(index, minlength=64), edges


class Trainer:
    """Training of one model on its device.

    :param vgg: the perceptual loss's frozen VGG19; by default a seeded one
        (``models.vgg.make_vgg``) in the model's dtype
    :param seed: seeds the noise generator (on the model's device), the
        default VGG and the loader's shuffle
    :param dataset: the training ``VideoDataset`` that ``train_epoch``
        iterates; ``train_step`` alone needs none
    :param logger: a ``utils.logging.Logger`` (default: stdout only)
    """

    def __init__(self, config: dict, model: Caddy, smooth_mi: bool = False,
                 vgg: Optional[Vgg19] = None, seed: int = 0, dataset=None,
                 logger: Optional[Logger] = None):
        self.config = config
        self.model = model
        self.smooth_mi = smooth_mi
        self.dataset = dataset
        self.logger = logger if logger is not None else Logger()
        self.device = model.centroids.device
        if vgg is None:
            self.logger.print("[trainer] WARNING: no pretrained VGG weights provided; "
                              "perceptual loss uses random VGG19 features")
            vgg = make_vgg(self.device, model.dtype, seed)
        self.vgg = vgg
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
        tpu = config.get("tpu", {})
        # Per-subnetwork gradient histograms, computed on the device (off by
        # default; the gradient norms are always on).
        self.grad_histograms = tpu.get("grad_histograms", False)
        self.dataloader = None
        if dataset is not None:
            batching = t["batching"]
            self.dataloader = DataLoader(
                dataset, batch_size=batching["batch_size"], shuffle=True, drop_last=True,
                num_workers=batching["num_workers"], prefetch=tpu.get("prefetch_batches", 2),
                seed=seed, worker_mode=batching.get("worker_mode", "thread"))
        self.average_meter = AverageMeter()
        # The action-space plots' inputs of the last step, on the device.
        self.plot_arrays: Dict[str, torch.Tensor] = {}
        # A profiler trace of 5 steps from the third step of the first
        # epoch, into tpu.profile_dir (or PVG_PROFILE_DIR) when it is set.
        self.profile_dir = tpu.get("profile_dir") or os.environ.get("PVG_PROFILE_DIR")
        self._profiler = None
        self._profile_stop_at = 0

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

    # Checkpoints.

    def _checkpoint_path(self, name: Optional[str]) -> str:
        return os.path.join(self.config["logging"]["save_root_directory"], name or "latest")

    def save_checkpoint(self, name: Optional[str] = None) -> None:
        """Saves the training state as ``name`` (default ``latest``) under
        the run's save directory."""
        ckpt_lib.save_checkpoint(self._checkpoint_path(name), self.state.state_dict())

    def load_checkpoint(self, name: Optional[str] = None) -> None:
        """Restores the training state saved as ``name`` (default
        ``latest``) into the state ``init_state`` built, and the step."""
        if self.state is None:
            raise RuntimeError("call init_state first")
        self.state.load_state_dict(ckpt_lib.restore_checkpoint(self._checkpoint_path(name)))
        self.global_step = self.state.step

    def load_reference_weights(self, path: str) -> None:
        """Imports the model's weights from a reference ``.pth.tar``
        checkpoint (the released CADDY checkpoints), converted by
        ``utils.reference_checkpoint``.  The optimizer's state and the step
        stay as ``init_state`` built them: an import, not a resume."""
        if self.state is None:
            raise RuntimeError("call init_state first")
        load_jax_variables(self.model, load_reference_checkpoint(path))
        self.logger.print(f"- Imported reference checkpoint weights from {path}")

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

    def get_observations_count(self, step: Optional[int] = None) -> int:
        """The annealed sequence length at ``step`` (default: the global
        step)."""
        b = self.config["training"]["batching"]
        return schedules.observations_count(
            self.global_step if step is None else step, b["observations_count_start"],
            b["observations_count"], b["observations_count_steps"])

    def train_step(self, batch) -> Dict[str, Any]:
        """One optimizer step on ``batch`` (``observations`` (B, T, H, W,
        3*stacking) in [-1, 1], channels last as the loader gives them, and
        ``actions`` (B, T); numpy arrays or tensors).  The phase is
        pretraining for the first ``pretraining_steps`` steps.

        :return: the loss, its terms and diagnostics, the global and
            per-subnetwork gradient norms, and the schedules' values, as
            floats; with ``tpu.grad_histograms``, also ``_grad_hist/<module>``
            (counts, edges) numpy pairs
        """
        if self.state is None:
            raise RuntimeError("call init_state first")
        state = self.state
        self.global_step += 1
        observations = sequence_to_nchw(batch.observations, self.device)
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
        histograms = {}
        if self.grad_histograms:
            histograms = {m: _histogram(torch.cat([x.flatten().float() for x in g]))
                          for m, g in modules.items()}
        state.optimizer.step()
        state.scheduler.step()
        if self.smooth_mi:
            state.mi_matrix = aux["new_mi_matrix"]
        state.step += 1
        self.plot_arrays = aux["plot_arrays"]

        metrics = dict(aux["info"])
        metrics["loss"] = total.detach()
        metrics["grad_norm/global"] = torch.sqrt(sum(squares.values()))
        for m, sq in squares.items():
            metrics[f"grad_norm/{m}"] = torch.sqrt(sq)
        values = torch.stack([v.float() for v in metrics.values()]).tolist()
        metrics = dict(zip(metrics, values))
        metrics.update(ground_truth_observations=gt_init, gumbel_temperature=gumbel_t,
                       observations_count=t, lr=lr, pretraining=float(pretraining))
        for m, (counts, edges) in histograms.items():
            metrics[f"_grad_hist/{m}"] = (counts.cpu().numpy(), edges.cpu().numpy())
        return metrics

    # Epoch loop.

    def _start_profile(self, stop_at: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.start()
        self._profile_stop_at = stop_at

    def _stop_profile(self) -> None:
        self._profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"trace_{self.global_step}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        self.profile_dir = None  # one window per run
        self.logger.print(f"- Wrote profiler trace to {path}")

    def _plot_action_space(self) -> None:
        """Direction-space and action-state plots of the last step."""
        out_dir = self.config["logging"].get("output_images_directory")
        if not out_dir:
            return
        from playablevideogeneration_tpu_torch.utils import tensor_displayer

        arrays = {k: v.float().cpu().numpy() for k, v in self.plot_arrays.items()}
        os.makedirs(out_dir, exist_ok=True)
        step = self.global_step
        tensor_displayer.show_action_directions(
            arrays["centroids"], arrays["action_directions_distribution"],
            arrays["action_probabilities"], os.path.join(out_dir, f"action_directions_{step}.png"))
        tensor_displayer.show_action_states(
            arrays["action_states_distribution"], arrays["action_probabilities"],
            os.path.join(out_dir, f"action_states_{step}.png"))

    def train_epoch(self, max_steps: Optional[int] = None) -> None:
        """One epoch over the loader: the sequence length is annealed at
        its start, and the epoch ends early when the length would change,
        after ``max_steps_per_epoch`` steps, or at ``max_steps``.

        The reference's quirks are kept: the epoch cap is
        ``performed_steps > max_steps_per_epoch``, the step that the length
        change ends the epoch on is counted without being taken, the meter
        is drained every step (so the 10-step log carries that step's
        values), and ground-truth frames are capped at T-1 (in
        ``train_step``).
        """
        if self.state is None:
            raise RuntimeError("call init_state or load_checkpoint first")
        if self.dataloader is None:
            raise RuntimeError("the trainer was built without a dataset")
        t = self.config["training"]
        self.logger.print(f"== Train [{self.global_step}] ==")
        observations_count = self.get_observations_count()
        self.dataset.set_observations_count(observations_count)

        performed_steps = 0
        for batch in self.dataloader:
            if performed_steps > t["max_steps_per_epoch"]:
                break
            if max_steps is not None and self.global_step >= max_steps:
                break
            performed_steps += 1
            step = self.global_step + 1
            if self.get_observations_count(step) != observations_count:
                self.global_step = step
                break
            if self.profile_dir is not None and self._profiler is None and performed_steps == 3:
                # Steps 1-2 of the epoch warm up; trace 5 steps from here.
                self._start_profile(stop_at=step + 5)
            elif self._profiler is not None and step >= self._profile_stop_at:
                self._stop_profile()

            start = time.perf_counter()
            metrics = self.train_step(batch)
            metrics["step_time"] = time.perf_counter() - start
            del metrics["lr"], metrics["pretraining"]
            grad_hists = {k[len("_grad_hist/"):]: metrics.pop(k)
                          for k in list(metrics) if k.startswith("_grad_hist/")}
            plot_freq = t["action_direction_plotting_freq"]
            if plot_freq and self.global_step % plot_freq == 0:
                self._plot_action_space()
            if self.device.type == "cuda":
                metrics["device_memory_mb"] = torch.cuda.memory_allocated(self.device) / 2 ** 20
            self.average_meter.add(metrics)

            # The learning rate of the next update.
            lr = self.state.scheduler.get_last_lr()[0]
            avg = {k: self.average_meter.pop(k) for k in metrics}
            parts = " ".join(f"{k}:{v:.3f}" for k, v in sorted(avg.items()) if k in _PRINTED)
            self.logger.print(f"step: {self.global_step}/{t['max_steps']} {parts} lr: {lr:.5f}")
            if (self.global_step - 1) % 10 == 0:
                logged = {f"train/{k}": v for k, v in avg.items()}
                logged["train/lr"] = lr
                for name, np_histogram in grad_hists.items():
                    hist = self.logger.histogram(np_histogram)
                    if hist is not None:
                        logged[f"train/grad_hist/{name}"] = hist
                self.logger.log(logged, step=self.global_step)

        if self._profiler is not None:  # a short epoch ends the window
            self._stop_profile()


def make_trainer(config: dict, model: Caddy, dataset, logger: Logger, **kwargs) -> Trainer:
    """Plain-MI trainer."""
    return Trainer(config, model, smooth_mi=False, dataset=dataset, logger=logger, **kwargs)
