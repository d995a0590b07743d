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

On a CUDA device the step's forward, backward, gradient norms and
histograms are one captured CUDA graph (``inference.graphs.TrainProgram``)
per ``(batch shape, phase, ground-truth frames)``, the counterpart of the
JAX trainer's ``jax.jit(train_step)`` per ``(T, pretraining)``; Adam and
the learning-rate schedule run eagerly after each replay, on the graph's
static gradients.  A new key releases the previous graph first, so at most
one lives.  On the CPU, through the ``graphs.Eager`` seam and with a
process group the step runs op by op.  A step is the span ``train.step``,
and inside it the batch's copy to the device ``train.upload``, Adam and
the schedule ``train.optimizer`` and the metrics' transfer to the host
``train.readback`` (``utils.tracing``).

With a process group (``parallel.mesh.init_distributed``) the trainer is
one rank of the JAX trainer's ``(data, model)`` mesh (``tpu.model_parallel``
ranks on the model axis, ``parallel.mesh.make_mesh``) with its
global-batch semantics: its loader yields its data index's rows of its
node's batch, the step runs inside ``parallel.mesh.global_batch`` (global
BatchNorm statistics, mutual-information joint, centroid EMA, noise and
diagnostics, reduced over the data group), the gradients are averaged over
the data group before Adam, and only rank 0 writes checkpoints, plots and
profiler traces.  Under tensor parallelism the wide kernels hold their
slice of the output channels (``models.layers.shard_model``, as the JAX
package's ``param_shardings``), and checkpoints and the evaluation see the
full model.
"""
from __future__ import annotations

import contextlib
import os
import time
import weakref
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from playablevideogeneration_tpu_torch.data.loader import DataLoader
from playablevideogeneration_tpu_torch.inference import graphs
from playablevideogeneration_tpu_torch.models import layers
from playablevideogeneration_tpu_torch.models.caddy import Caddy
from playablevideogeneration_tpu_torch.models.centroids import average_centroid_distance
from playablevideogeneration_tpu_torch.models.vgg import Vgg19, make_vgg
from playablevideogeneration_tpu_torch.parallel import mesh
from playablevideogeneration_tpu_torch.training import losses, schedules
from playablevideogeneration_tpu_torch.training.train_state import TrainState
from playablevideogeneration_tpu_torch.utils import checkpoint as ckpt_lib
from playablevideogeneration_tpu_torch.utils import pretrained, tracing
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables
from playablevideogeneration_tpu_torch.utils.logging import AverageMeter, Logger
from playablevideogeneration_tpu_torch.utils.reference_checkpoint import (
    load_reference_checkpoint,
)
from playablevideogeneration_tpu_torch.utils.tensor_ops import sequence_to_nchw

# Metrics of train_step that train_epoch prints every step.
_PRINTED = ("loss", "avg_observations_rec_loss", "avg_perceptual_loss", "states_rec_loss",
            "action_mutual_information_loss", "step_time")
_STEP = tracing.span("train.step")
_UPLOAD = tracing.span("train.upload")
_OPTIMIZER = tracing.span("train.optimizer")
_READBACK = tracing.span("train.readback")


def compute_loss_terms(model: Caddy, observations: torch.Tensor, actions: torch.Tensor,
                       gt_init: int, gumbel_temperature,
                       generator: torch.Generator, vgg: Vgg19,
                       loss_weights: Dict[str, float], mi_lambda: float, pretraining: bool,
                       use_motion_weights: bool, motion_weights_bias: float,
                       mi_matrix: Optional[torch.Tensor], mi_alpha: Optional[float]
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Forward and every loss term.

    :param observations: (B, T, 3*stacking, H, W) in [-1, 1]
    :param actions: (B, T) ground-truth action indices
    :param gumbel_temperature: a float, or a 0-d f32 tensor on the model's
        device (the trainer's, so that a captured step replays with each
        step's value)
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
            mesh.mean_over_ranks(out.action_samples.mean(dim=(0, 1)))[None]),
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
    edges.  The counts are a scatter of ones, which a graph can record:
    ``torch.bincount`` reads its maximum back to the host."""
    lo, hi = values.min(), values.max()
    hi = torch.where(hi <= lo, lo + 1e-12, hi)
    edges = lo + (hi - lo) * torch.linspace(0.0, 1.0, 65, device=values.device)
    index = (torch.searchsorted(edges, values, right=True) - 1).clamp(0, 63)
    counts = torch.zeros(64, dtype=torch.int64, device=values.device)
    return counts.scatter_add_(0, index, torch.ones_like(index)), edges


class Trainer:
    """Training of one model on its device.

    :param vgg: the perceptual loss's frozen VGG19; by default the config's
        converted weights (``utils.pretrained.get_vgg_variables``), or a
        seeded one (``models.vgg.make_vgg``) when there are none, computing
        in the model's dtype
    :param seed: seeds the noise generator (on the model's device), the
        random VGG and the loader's shuffle
    :param dataset: the training ``VideoDataset`` that ``train_epoch``
        iterates; ``train_step`` alone needs none
    :param logger: a ``utils.logging.Logger`` (default: stdout only, on
        rank 0)
    :param backend: for the tests, the profiler and the chip check only:
        ``graphs.StandIn`` or ``graphs.Eager``; by default the device
        decides (``graphs.resolve_backend``)

    The ranks form a mesh of ``world / M`` x ``M``, ``M`` being
    ``tpu.model_parallel``: a world or a node's ranks that ``M`` does not
    divide raise, and so does a ``tpu.data_parallel_devices`` (counted over
    every node, as the JAX package counts devices over every process) whose
    product with ``M`` is not the world.
    """

    def __init__(self, config: dict, model: Caddy, smooth_mi: bool = False,
                 vgg: Optional[Vgg19] = None, seed: int = 0, dataset=None,
                 logger: Optional[Logger] = None, backend: Optional[type] = None):
        tpu = config.get("tpu", {})
        self.process = mesh.process_info()
        self.distributed = dist.is_initialized()
        model_parallel = tpu.get("model_parallel", 1)
        devices = tpu.get("data_parallel_devices")
        if devices is not None and devices * model_parallel != self.process.world:
            # The JAX trainer caps its mesh to the first N * M devices; a
            # rank is a device here, and a rank left out of the mesh would
            # have nothing to do.
            raise ValueError(f"tpu.data_parallel_devices is {devices} with "
                             f"tpu.model_parallel {model_parallel}, but {self.process.world} "
                             f"rank(s) run: the mesh must take every rank")
        self.mesh = mesh.make_mesh(self.process, model_parallel)
        self.tp_min_channels = tpu.get("tp_min_channels", 256)
        self.config = config
        self.model = model
        self.smooth_mi = smooth_mi
        self.dataset = dataset
        self.logger = logger if logger is not None else Logger(enabled=self.process.rank == 0)
        self.device = model.centroids.device
        if vgg is None:
            variables, found = pretrained.get_vgg_variables(config, self.logger)
            if found:
                vgg = load_jax_variables(Vgg19(model.dtype), variables).to(self.device).eval()
            else:
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
        # Per-subnetwork gradient histograms, computed on the device (off by
        # default; the gradient norms are always on).
        self.grad_histograms = tpu.get("grad_histograms", False)
        self.dataloader = None
        if dataset is not None:
            # A node loads the JAX process's shard of the epoch, and each of
            # its data indices takes its contiguous rows of every batch: the
            # ranks of a model group load the same rows.
            batching, process, m = t["batching"], self.process, model_parallel
            self.dataloader = DataLoader(
                dataset, batch_size=batching["batch_size"], shuffle=True, drop_last=True,
                num_workers=batching["num_workers"], prefetch=tpu.get("prefetch_batches", 2),
                seed=seed, worker_mode=batching.get("worker_mode", "thread"),
                shard_index=process.node, shard_count=process.nodes,
                local_rank=process.local_rank // m, local_world=process.local_world // m)
        self.average_meter = AverageMeter()
        # The action-space plots' inputs of the last step, on the device.
        self.plot_arrays: Dict[str, torch.Tensor] = {}
        # A profiler trace of 5 steps from the third step of the first
        # epoch, into tpu.profile_dir (or PVG_PROFILE_DIR) when it is set,
        # by rank 0.
        self.profile_dir = ((tpu.get("profile_dir") or os.environ.get("PVG_PROFILE_DIR"))
                            if self.process.rank == 0 else None)
        self._profiler = None
        self._profile_stop_at = 0
        self._backend = graphs.resolve_backend(self.device, backend)
        # The train step's graph, its key and its metrics' names; captures
        # counts the graphs recorded.
        self._program: Optional[graphs.TrainProgram] = None
        self._program_key = None
        self._program_names: list = []
        self.captures = 0

    def init_state(self) -> TrainState:
        """Puts the model in training mode and builds the optimizer, the
        learning-rate schedule and the uniform MI matrix; with a process
        group, rank 0's parameters and buffers first replace every rank's,
        and then each sharded layer keeps this rank's slice, so that Adam's
        moments are slices too."""
        self.drop_program()
        self.model.train()
        if self.distributed:
            mesh.broadcast_from_rank0(self.model)
        layers.shard_model(self.model, self.mesh, self.tp_min_channels)
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
        the run's save directory, in full tensors: rank 0's model group
        gathers the sharded ones, rank 0 writes them, every data index's
        state being the same, and the others wait for it."""
        if self.mesh.data_index == 0:
            state = self.state.state_dict()
            if self.process.rank == 0:
                ckpt_lib.save_checkpoint(self._checkpoint_path(name), state)
        if self.distributed:
            mesh.barrier()

    def load_checkpoint(self, name: Optional[str] = None) -> None:
        """Restores the training state saved as ``name`` (default
        ``latest``) into the state ``init_state`` built, and the step.
        Every rank reads the file to the CPU and copies it (of a sharded
        tensor, its slice) to its device, whatever mesh wrote it."""
        if self.state is None:
            raise RuntimeError("call init_state first")
        self.drop_program()  # the MI matrix is replaced
        self.state.load_state_dict(ckpt_lib.restore_checkpoint(self._checkpoint_path(name)))
        self.global_step = self.state.step
        if self.distributed:
            mesh.barrier()

    def load_reference_weights(self, path: str) -> None:
        """Imports the model's weights from a reference ``.pth.tar``
        checkpoint (the released CADDY checkpoints), converted by
        ``utils.reference_checkpoint``.  The optimizer's state and the step
        stay as ``init_state`` built them: an import, not a resume.  A
        sharded model refuses the full-size weights (``load_jax_variables``
        checks every shape)."""
        if self.state is None:
            raise RuntimeError("call init_state first")
        self.drop_program()
        load_jax_variables(self.model, load_reference_checkpoint(path))
        self.logger.print(f"- Imported reference checkpoint weights from {path}")

    @contextlib.contextmanager
    def full_model_in(self, *evaluators) -> Iterator[Caddy]:
        """Within the block the ``evaluators`` see the whole model: under
        tensor parallelism a full-width copy (``layers.unsharded_copy``)
        that every rank of the model group must join in gathering, which
        holds one more set of the model's parameters while it lasts;
        otherwise the model itself."""
        model = layers.unsharded_copy(self.model)
        saved = [evaluator.model for evaluator in evaluators]
        for evaluator in evaluators:
            evaluator.model = model
        try:
            yield model
        finally:
            for evaluator, previous in zip(evaluators, saved):
                evaluator.model = previous

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

    def drop_program(self) -> None:
        """Releases the train step's graph and its memory pool: the program,
        the static gradients the parameters point at and the plot arrays
        among its outputs.  The next step captures anew."""
        if self._program is None:
            return
        self._program = self._program_key = None
        for p in self.model.parameters():
            p.grad = None
        self.plot_arrays = {}

    def _gradients(self, observations: torch.Tensor, actions: torch.Tensor,
                   temperature: torch.Tensor, mi_matrix: Optional[torch.Tensor],
                   gt_init: int, pretraining: bool) -> Tuple[list, Dict[str, Any]]:
        """The step up to the optimizer: forward, backward, the zero
        gradients of unused parameters, the norms and the optional
        histograms.  Returns the metrics' names and, on the device, their
        values (``values``), the parameters' gradients (``grads``), the
        histograms, the plot arrays and the new MI matrix."""
        global_batch = (mesh.global_batch(self.mesh) if self.distributed
                        else contextlib.nullcontext())
        with global_batch:
            total, aux = compute_loss_terms(
                self.model, observations, actions, gt_init, temperature, self.generator,
                self.vgg, pretraining=pretraining, mi_matrix=mi_matrix, **self._loss_kwargs)
            total.backward()

            # A parameter the phase does not use (state_to_hidden in the
            # full phase) takes a zero gradient, so that Adam decays it as
            # optax does.  The gradients of sharded slices are kept apart,
            # by module, for the norms.
            sharded = {id(layer.weight): layer
                       for layer in layers.sharded_layers(self.model).values()}
            modules: Dict[str, list] = {}
            slices: Dict[str, list] = {}
            for name, p in self.model.named_parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads = slices if id(p) in sharded else modules
                grads.setdefault(name.split(".")[0], []).append(p)
            if self.distributed:
                mesh.all_reduce_gradients(self.model.parameters(), self.mesh)
            # The rank's losses and diagnostics are means over its rows (or
            # global already): their mean over the data group is the global one.
            local = dict(aux["info"], loss=total.detach())
            averaged = mesh.mean_over_ranks(torch.stack([v.float() for v in local.values()]))
        squares = {m: torch.stack(torch._foreach_norm([p.grad for p in ps])).square().sum()
                   for m, ps in modules.items()}
        if slices:
            # A sharded gradient's squared norm is the sum of its slices'.
            names = sorted(slices)
            partial = mesh.gather_rows(torch.stack([
                torch.stack(torch._foreach_norm([p.grad for p in slices[m]])).square().sum()
                for m in names])[None], self.mesh).sum(dim=0)
            for m, sq in zip(names, partial):
                squares[m] = squares[m] + sq if m in squares else sq
        histograms = {}
        if self.grad_histograms:
            full = {m: [p.grad for p in ps] for m, ps in modules.items()}
            for m, ps in slices.items():
                full.setdefault(m, []).extend(sharded[id(p)].gather(p.grad) for p in ps)
            histograms = {m: _histogram(torch.cat([x.flatten().float() for x in g]))
                          for m, g in full.items()}
        norms = {"grad_norm/global": torch.sqrt(sum(squares.values()))}
        for m, sq in squares.items():
            norms[f"grad_norm/{m}"] = torch.sqrt(sq)
        return list(local) + list(norms), dict(
            values=torch.cat([averaged, torch.stack(list(norms.values()))]),
            grads=[p.grad for p in self.model.parameters()], histograms=histograms,
            plot_arrays=aux["plot_arrays"], new_mi_matrix=aux["new_mi_matrix"])

    def _replay(self, observations: torch.Tensor, actions: torch.Tensor,
                temperature: torch.Tensor, gt_init: int, pretraining: bool
                ) -> Tuple[list, Dict[str, Any]]:
        """``_gradients`` as a replay of the graph of its key, captured
        first when the key, the generator or the MI matrix is new; the
        parameters' ``.grad`` pointed at the graph's static gradients.  The
        new MI matrix is written into the state's in place."""
        key = (tuple(observations.shape), pretraining, gt_init)
        mi = [self.state.mi_matrix] if self.smooth_mi else []
        if (self._program is None or self._program_key != key
                or self._program.generators[0] is not self.generator
                or any(a is not b for a, b in zip(self._program.state, mi))):
            # The old graph's pool goes first: nothing may hold the old
            # program while the new one warms up and records.
            self.drop_program()
            names = self._program_names = []
            # Through a weak reference: the program the trainer holds must
            # not hold the trainer, or a dropped trainer's graph and its
            # pool would wait for the cycle collector.
            trainer = weakref.proxy(self)

            def step(*tensors):
                *mi_state, obs, acts, temp = tensors
                step_names, outputs = trainer._gradients(
                    obs, acts, temp, mi_state[0] if mi_state else None, gt_init, pretraining)
                names[:] = step_names
                new_mi = outputs.pop("new_mi_matrix")
                return [new_mi] if mi_state else [], outputs

            self._program = graphs.TrainProgram(
                step, mi, [observations.clone(), actions.clone(), temperature.clone()],
                self.model, self._backend, generators=(self.generator,))
            self._program_key = key
            self.captures += 1
        outputs = self._program(observations, actions, temperature)
        for p, grad in zip(self.model.parameters(), outputs["grads"]):
            p.grad = grad
        return self._program_names, outputs

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
        self.global_step += 1
        with _STEP(global_step=self.global_step):
            return self._train_step(batch)

    def _train_step(self, batch) -> Dict[str, Any]:
        """``train_step`` after its global step is taken, inside its span."""
        state = self.state
        with _UPLOAD:
            observations = sequence_to_nchw(batch.observations, self.device)
            actions = torch.as_tensor(batch.actions, device=self.device)
        t = observations.shape[1]
        pretraining = self.global_step <= self.config["training"]["pretraining_steps"]
        gt_init = min(self.get_ground_truth_observations_count(), t - 1)
        gumbel_t = self.get_gumbel_temperature()
        # A 0-d f32 tensor, as the JAX step takes it: a graph replays with
        # each step's value, where a Python float would be recorded.
        temperature = torch.full((), gumbel_t, dtype=torch.float32, device=self.device)
        lr = state.scheduler.get_last_lr()[0]

        if self._backend is None or self.distributed:
            # Op by op: on the CPU, through the seam, or with a process
            # group, whose gloo collectives copy through the host and cannot
            # be captured.
            state.optimizer.zero_grad(set_to_none=True)
            names, outputs = self._gradients(
                observations, actions, temperature,
                state.mi_matrix if self.smooth_mi else None, gt_init, pretraining)
            if self.smooth_mi:
                state.mi_matrix = outputs["new_mi_matrix"]
        else:
            names, outputs = self._replay(observations, actions, temperature, gt_init,
                                          pretraining)
        with _OPTIMIZER:
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        self.plot_arrays = outputs["plot_arrays"]

        with _READBACK:
            metrics = dict(zip(names, outputs["values"].tolist()))
            metrics.update(ground_truth_observations=gt_init, gumbel_temperature=gumbel_t,
                           observations_count=t, lr=lr, pretraining=float(pretraining))
            for m, (counts, edges) in outputs["histograms"].items():
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
            if plot_freq and self.global_step % plot_freq == 0 and self.process.rank == 0:
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
