"""CADDY, the playable-video-generation model: play and training routes.

Counterpart of ``playablevideogeneration_tpu/models/caddy.py``: E
(representation), A (action networks), R (dynamics), D (rendering),
``state_to_hidden`` and the action centroids, with ``init_play`` and
``play_step`` for interactive generation and ``forward_full_model`` and
``forward_pretraining`` for training.

The modules index their tensors (N, C, H, W) and keep them in
channels-last storage (``models.layers``), the JAX package's NHWC in
memory.  ``init_play`` and ``play_step`` keep the JAX package's NHWC
shapes at their boundary: a permutation of the same storage, so that
nothing is copied between steps.  The training forwards take and return
channels-first sequences (B, T, C, H, W) stored channels-last; the
trainer's view of the loader's NHWC batch is one, and the frames, states
and hidden states the forwards stack over time are joined into the same
storage (``utils.tensor_ops.stack``), so that flattening the time into
the batch is a view.

The JAX ``lax.scan`` over time is a Python loop over the T-1 steps.  With
``checkpoint_steps`` each step runs under ``torch.utils.checkpoint``, the
counterpart of the JAX package's ``remat``: the backward pass reruns the
step's forward instead of keeping its activations, and the rerun leaves
the BatchNorm running statistics alone (``layers.frozen_statistics``), so
they are folded once per step as in the scan.  Noise comes from an
explicit ``torch.Generator``: the action networks draw twice per call and
Gumbel once per forward; no per-step noise is drawn, as the JAX package
draws none (the reference's dynamics network never reads it).
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from playablevideogeneration_tpu_torch.models import centroids as centroid_ops
from playablevideogeneration_tpu_torch.models.action import ActionNetwork
from playablevideogeneration_tpu_torch.models.dynamics import (
    ConvDynamicsNetwork,
    DynamicsCarry,
)
from playablevideogeneration_tpu_torch.models.gumbel import gumbel_softmax_sample
from playablevideogeneration_tpu_torch.models.layers import Conv2d, frozen_statistics
from playablevideogeneration_tpu_torch.models.outputs import ModelOutput
from playablevideogeneration_tpu_torch.models.rendering import RenderingNetwork
from playablevideogeneration_tpu_torch.models.representation import RepresentationNetwork
from playablevideogeneration_tpu_torch.utils import tensor_ops as tops
from playablevideogeneration_tpu_torch.utils.device import DeviceLike, resolve_device

# (log_probs (N, A), ground_truth_actions (N,)) -> samples (N, A)
ActionSampler = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# (sampled_directions (N, D), samples (N, A)) -> variations (N, D)
VariationSampler = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W) in ``dtype``, channels-last: a view of
    NHWC storage, copied only when the storage is not NHWC."""
    return x.permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)


class Caddy(nn.Module):
    def __init__(self, actions_count: int, action_space_dimension: int,
                 state_features: int, state_resolution: Tuple[int, int],
                 hidden_state_size: int, observation_stacking: int,
                 use_gumbel: bool = True, hard_gumbel: bool = False,
                 use_variations: bool = True, centroid_alpha: float = 0.1,
                 ensemble_size: int = 1, pretraining_detach: bool = False,
                 checkpoint_steps: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.actions_count = actions_count
        self.action_space_dimension = action_space_dimension
        self.state_features = state_features
        self.state_resolution = tuple(state_resolution)
        self.hidden_state_size = hidden_state_size
        self.observation_stacking = observation_stacking
        self.use_gumbel = use_gumbel
        self.hard_gumbel = hard_gumbel
        self.use_variations = use_variations
        self.centroid_alpha = centroid_alpha
        self.ensemble_size = ensemble_size
        # Detach the dynamics input states during pretraining (the full
        # forward refuses it, as the JAX package does).
        self.pretraining_detach = pretraining_detach
        self.checkpoint_steps = checkpoint_steps
        self.dtype = dtype
        hs = hidden_state_size
        self.representation_network = RepresentationNetwork(
            3 * observation_stacking, state_features, dtype)
        for i in range(ensemble_size):
            self.add_module(f"action_network_{i}", ActionNetwork(
                state_features, actions_count, action_space_dimension, dtype))
        self.dynamics_network = ConvDynamicsNetwork(
            state_features, actions_count, action_space_dimension, hs,
            self.state_resolution, dtype)
        self.rendering_network = RenderingNetwork(hs, (hs, hs // 2, hs // 4), dtype)
        # Projects states to hidden states during pretraining.
        self.state_to_hidden = Conv2d(state_features, hs, 3, True, dtype)
        self.register_buffer("centroids",
                             torch.zeros(actions_count, action_space_dimension))

    def action_networks(self, index: int) -> ActionNetwork:
        """The ensemble's ``index``-th action network."""
        return getattr(self, f"action_network_{index}")

    # ------------------------------------------------------------------ #
    # Interactive inference                                              #
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def init_play(self, batch_size: int = 1) -> DynamicsCarry:
        """Fresh recurrent state for interactive generation, NHWC, in the
        model dtype."""
        return tuple((_nhwc(h), _nhwc(c))
                     for h, c in self.dynamics_network.init_carry(batch_size))

    @torch.no_grad()
    def play_step(self, carry: DynamicsCarry, observation: torch.Tensor,
                  action_onehot: torch.Tensor, variation: torch.Tensor):
        """One interactive generation step.

        :param carry: NHWC ((h, c) x 3) from ``init_play`` or the last step
        :param observation: (B, H, W, 3*observation_stacking) current window,
            newest frame first along channels
        :param action_onehot: (B, actions_count)
        :param variation: (B, action_space_dimension)
        :return: (new_carry, frame (B, H, W, 3), next_observation window),
            in the model dtype
        """
        obs = _nchw(observation, self.dtype)
        carry = tuple((_nchw(h, self.dtype), _nchw(c, self.dtype)) for h, c in carry)
        state, _ = self.representation_network(obs)
        carry, hidden = self.dynamics_network(
            carry, state, action_onehot.to(self.dtype), variation.to(self.dtype))
        frame, _ = self.rendering_network(hidden)
        next_observation = tops.cat([frame, obs[:, :-3]], dim=1)
        carry = tuple((_nhwc(h), _nhwc(c)) for h, c in carry)
        return carry, _nhwc(frame), _nhwc(next_observation)

    # ------------------------------------------------------------------ #
    # Training forwards                                                  #
    # ------------------------------------------------------------------ #

    def _run_step(self, step: Callable, *args):
        """Runs one time step, under activation checkpointing when it is on
        and gradients are recorded; the recompute folds no statistics."""
        if not (self.checkpoint_steps and torch.is_grad_enabled()):
            return step(*args)
        return checkpoint(
            step, *args, use_reentrant=False, preserve_rng_state=False,
            context_fn=lambda: (contextlib.nullcontext(), frozen_statistics(self)))

    def _encode_and_act(self, observations, actions, gumbel_temperature, generator,
                        action_sampler, variation_sampler, ensemble_index) -> dict:
        b, t = observations.shape[:2]
        states_flat, attention_flat = self.representation_network(
            tops.flatten(observations).to(self.dtype))
        states = tops.fold(states_flat, t)
        attention = tops.fold(attention_flat, t)

        (logits, dirs_dist, sampled_dirs, states_dist,
         sampled_states) = self.action_networks(ensemble_index)(generator, states, attention)
        flat_logits = tops.flatten(logits)
        flat_log_probs = F.log_softmax(flat_logits, dim=-1)
        flat_probs = F.softmax(flat_logits, dim=-1)

        # The EMA centroid update comes before the variations, in training
        # only.  A copy is used, so a later update cannot touch what
        # autograd saved.
        if self.training:
            self.centroids.copy_(centroid_ops.update_centroids(
                self.centroids, tops.flatten(dirs_dist), flat_probs, self.centroid_alpha))
        current_centroids = self.centroids.clone()

        if action_sampler is not None:
            flat_samples = action_sampler(flat_log_probs, actions[:, :-1].reshape(-1))
        elif self.use_gumbel:
            flat_samples = gumbel_softmax_sample(generator, flat_log_probs,
                                                 gumbel_temperature, hard=self.hard_gumbel)
        else:
            flat_samples = flat_probs

        flat_sampled_dirs = tops.flatten(sampled_dirs)
        flat_variations = centroid_ops.compute_variations(
            flat_sampled_dirs, flat_samples, current_centroids)
        if not self.use_variations:
            flat_variations = flat_variations * 0.0
        if variation_sampler is not None:
            flat_variations = variation_sampler(flat_sampled_dirs, flat_samples)

        action_samples = tops.fold(flat_samples, t - 1)
        return dict(
            states=states, attention=attention, logits=logits, dirs_dist=dirs_dist,
            sampled_dirs=sampled_dirs, states_dist=states_dist,
            sampled_states=sampled_states, action_samples=action_samples,
            variations=tops.fold(flat_variations, t - 1),
            selected_actions=torch.argmax(action_samples, dim=2))

    def forward(self, observations: torch.Tensor, actions: torch.Tensor,
                ground_truth_observations_init: int, *, generator: torch.Generator,
                pretraining: bool = False, gumbel_temperature: float = 1.0,
                action_sampler: Optional[ActionSampler] = None,
                variation_sampler: Optional[VariationSampler] = None,
                ensemble_index: int = 0) -> ModelOutput:
        """Training or evaluation forward, by the module's ``training``
        flag (BatchNorm statistics, centroid update).

        :param observations: (B, T, 3*observation_stacking, H, W), frames
            most-recent-first along channels, values in [-1, 1]
        :param actions: (B, T) int ground-truth action indices
        :param ground_truth_observations_init: number of ground-truth frames
            fed before autoregression (full forward only)
        :param generator: the source of the action networks' and Gumbel's noise
        """
        kwargs = dict(generator=generator, gumbel_temperature=gumbel_temperature,
                      action_sampler=action_sampler, variation_sampler=variation_sampler,
                      ensemble_index=ensemble_index)
        if pretraining:
            return self.forward_pretraining(observations, actions, **kwargs)
        return self.forward_full_model(observations, actions,
                                       ground_truth_observations_init, **kwargs)

    def forward_full_model(self, observations, actions, ground_truth_observations_init: int,
                           *, generator: torch.Generator, gumbel_temperature: float = 1.0,
                           action_sampler: Optional[ActionSampler] = None,
                           variation_sampler: Optional[VariationSampler] = None,
                           ensemble_index: int = 0) -> ModelOutput:
        """Autoregressive forward with teacher forcing on the first
        ``ground_truth_observations_init`` frames."""
        if self.pretraining_detach:
            raise NotImplementedError(
                "pretraining_detach is not supported by the full model")
        b, t = observations.shape[:2]
        # Cast whole, then sliced: a cast of a slice of the time axis would
        # be stored channels-first.
        observations = observations.to(self.dtype)
        front = self._encode_and_act(observations, actions, gumbel_temperature, generator,
                                     action_sampler, variation_sampler, ensemble_index)
        states, attention = front["states"], front["attention"]
        action = front["action_samples"].to(self.dtype)
        variation = front["variations"].to(self.dtype)
        gt_window = observations[:, 1:]

        def step(is_gt, carry, window, cur_state, action, variation, gt_state, gt_att,
                 gt_window):
            carry, hidden = self.dynamics_network(carry, cur_state, action, variation)
            recon_full, recons = self.rendering_network(hidden)
            # Slide the stacked window: newest frame first, oldest 3
            # channels dropped.
            if is_gt:
                # A slice of the sequence: compacted here, where the
                # encoder's first convolution would copy it.
                new_window = gt_window.contiguous(memory_format=torch.channels_last)
            else:
                new_window = tops.cat([recon_full, window[:, :-3]], dim=1)
            # The window is re-encoded on every step, ground-truth steps
            # included, so the BatchNorm statistics see what the JAX scan's
            # see; ground-truth steps then select the up-front encoding.
            comp_state, comp_att = self.representation_network(new_window)
            next_state = gt_state if is_gt else comp_state
            next_att = gt_att if is_gt else comp_att
            return carry, new_window, next_state, next_att, hidden, recons

        carry = self.dynamics_network.init_carry(b)
        window = observations[:, 0]
        cur_state = states[:, 0]
        hiddens, recons, next_states, next_atts = [], [], [], []
        for i in range(t - 1):
            carry, window, cur_state, next_att, hidden, recon = self._run_step(
                step, i + 1 < ground_truth_observations_init, carry, window, cur_state,
                action[:, i], variation[:, i], states[:, i + 1], attention[:, i + 1],
                gt_window[:, i])
            hiddens.append(hidden)
            recons.append(recon)
            next_states.append(cur_state)
            next_atts.append(next_att)

        multires = [tops.stack(level, dim=1) for level in zip(*recons)]
        reconstructed_states = tops.cat(
            [states[:, 0:1], tops.stack(next_states, dim=1)], dim=1)
        reconstructed_attention = tops.stack(next_atts, dim=1)
        complete_attention = tops.cat([attention[:, 0:1], reconstructed_attention], dim=1)
        # Actions re-estimated on the reconstructed sequence, for the MI loss.
        (r_logits, r_dirs_dist, r_sampled_dirs, r_states_dist,
         r_sampled_states) = self.action_networks(ensemble_index)(
            generator, reconstructed_states, complete_attention)

        return ModelOutput(
            reconstructed_observations=multires[0],
            multiresolution_reconstructed_observations=multires,
            reconstructed_states=reconstructed_states,
            states=states,
            hidden_states=tops.stack(hiddens, dim=1),
            selected_actions=front["selected_actions"],
            action_logits=front["logits"],
            action_samples=front["action_samples"],
            attention=attention,
            reconstructed_attention=reconstructed_attention,
            action_directions_distribution=front["dirs_dist"],
            sampled_action_directions=front["sampled_dirs"],
            action_states_distribution=front["states_dist"],
            sampled_action_states=front["sampled_states"],
            action_variations=front["variations"],
            reconstructed_action_logits=r_logits,
            reconstructed_action_directions_distribution=r_dirs_dist,
            reconstructed_sampled_action_directions=r_sampled_dirs,
            reconstructed_action_states_distribution=r_states_dist,
            reconstructed_sampled_action_states=r_sampled_states,
        )

    def forward_pretraining(self, observations, actions, *, generator: torch.Generator,
                            gumbel_temperature: float = 1.0,
                            action_sampler: Optional[ActionSampler] = None,
                            variation_sampler: Optional[VariationSampler] = None,
                            ensemble_index: int = 0) -> ModelOutput:
        """Pretraining forward: no autoregressive feedback; the dynamics run
        over the ground-truth states and D decodes ``state_to_hidden`` of
        them."""
        b, t = observations.shape[:2]
        front = self._encode_and_act(observations, actions, gumbel_temperature, generator,
                                     action_sampler, variation_sampler, ensemble_index)
        states, attention = front["states"], front["attention"]

        # The states are a slice of the encoder's channels: compacted here,
        # where the convolution would copy them.
        flat_recon_hidden = self.state_to_hidden(
            tops.flatten(states).contiguous(memory_format=torch.channels_last))
        _, flat_multires = self.rendering_network(flat_recon_hidden)
        multires = [tops.fold(r, t) for r in flat_multires]

        input_states = states[:, :-1]
        if self.pretraining_detach:
            # No gradient from the dynamics into the representation network.
            input_states = input_states.detach()
        action = front["action_samples"].to(self.dtype)
        variation = front["variations"].to(self.dtype)
        carry = self.dynamics_network.init_carry(b)
        hiddens = []
        for i in range(t - 1):
            carry, hidden = self._run_step(self.dynamics_network, carry, input_states[:, i],
                                           action[:, i], variation[:, i])
            hiddens.append(hidden)

        # Re-encode the decoded frames and re-estimate the actions.
        stacked = self.compute_stacked_observations(multires[0])
        r_states_flat, r_att_flat = self.representation_network(tops.flatten(stacked))
        reconstructed_states = tops.fold(r_states_flat, t)
        reconstructed_attention = tops.fold(r_att_flat, t)
        (r_logits, r_dirs_dist, r_sampled_dirs, r_states_dist,
         r_sampled_states) = self.action_networks(ensemble_index)(
            generator, reconstructed_states, reconstructed_attention)

        return ModelOutput(
            reconstructed_observations=multires[0],
            multiresolution_reconstructed_observations=multires,
            reconstructed_states=reconstructed_states,
            states=states,
            hidden_states=tops.stack(hiddens, dim=1),
            reconstructed_hidden_states=tops.fold(flat_recon_hidden, t),
            selected_actions=front["selected_actions"],
            action_logits=front["logits"],
            action_samples=front["action_samples"],
            attention=attention,
            action_directions_distribution=front["dirs_dist"],
            sampled_action_directions=front["sampled_dirs"],
            action_states_distribution=front["states_dist"],
            sampled_action_states=front["sampled_states"],
            action_variations=front["variations"],
            reconstructed_action_logits=r_logits,
            reconstructed_action_directions_distribution=r_dirs_dist,
            reconstructed_sampled_action_directions=r_sampled_dirs,
            reconstructed_action_states_distribution=r_states_dist,
            reconstructed_sampled_action_states=r_sampled_states,
        )

    def compute_stacked_observations(self, observations: torch.Tensor) -> torch.Tensor:
        """(B, T, 3, H, W) frames -> (B, T, 3*stacking, H, W) stacked
        observations, newest first, clamped at the sequence start."""
        seqs: List[torch.Tensor] = [observations]
        for k in range(1, self.observation_stacking):
            repeated_first = observations[:, 0:1].expand(-1, k, -1, -1, -1)
            seqs.append(tops.cat([repeated_first, observations[:, :-k]], dim=1))
        return tops.cat(seqs, dim=2)


@torch.no_grad()
def seeded_init(model: nn.Module, seed: int) -> nn.Module:
    """Fills every parameter and buffer from a generator seeded with
    ``seed``, on the CPU, so a seed gives the same weights on any device:
    conv and dense kernels LeCun-normal, BN scales in [0.5, 1.5], biases,
    BN means and initial LSTM states N(0, 0.1^2), BN variances in [0.5, 2],
    centroids N(0, 1).  The BN statistics are far from (0, 1) on purpose,
    so the normalisation does real work."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    def uniform(shape, low, high):
        return torch.rand(shape, generator=gen) * (high - low) + low

    for name, tensor in itertools.chain(model.named_parameters(), model.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        if tensor.dim() in (2, 4) and leaf == "weight":
            value = normal(tensor.shape, tensor[0].numel() ** -0.5)
        elif leaf == "weight":
            value = uniform(tensor.shape, 0.5, 1.5)
        elif leaf in ("bias", "running_mean") or leaf.startswith("initial_"):
            value = normal(tensor.shape, 0.1)
        elif leaf == "running_var":
            value = uniform(tensor.shape, 0.5, 2.0)
        elif leaf == "centroids":
            value = normal(tensor.shape, 1.0)
        else:
            raise ValueError(f"no seeded init for {name}")
        tensor.copy_(value)
    return model


def _place(model: Caddy, device: DeviceLike, seed: int) -> Caddy:
    device = resolve_device(device)
    return seeded_init(model, seed).to(device).eval()


def make_model(config: dict, device: DeviceLike = "cuda", seed: int = 0) -> Caddy:
    """Builds the model from a configuration dict (the YAML schema of
    ``configs/*.yaml``), with weights seeded from ``seed``, on ``device``,
    in evaluation mode (``.train()`` selects the training behaviour).

    Reads every key that the JAX ``make_model`` reads and rejects
    ``use_ground_truth_actions`` as it does.  ``tpu.remat`` selects
    per-step activation checkpointing; the other ``tpu`` knobs
    (``remat_policy``, ``rendering_subpixel*``, ``resize_impl``,
    ``stem_subpixel``, ``fuse_upsample``) choose TPU layouts or selective
    remat policies with the same math and have no counterpart here.
    """
    m = config["model"]
    t = config["training"]
    if t.get("use_ground_truth_actions"):
        raise NotImplementedError(
            "use_ground_truth_actions during training is not supported by "
            "the selected model")
    tpu = config.get("tpu", {})
    action = m["action_network"]
    model = Caddy(
        actions_count=config["data"]["actions_count"],
        action_space_dimension=action["action_space_dimension"],
        state_features=m["representation_network"]["state_features"],
        state_resolution=tuple(m["representation_network"]["state_resolution"]),
        hidden_state_size=m["dynamics_network"]["hidden_state_size"],
        observation_stacking=t["batching"]["observation_stacking"],
        use_gumbel=action["use_gumbel"],
        hard_gumbel=action["hard_gumbel"],
        use_variations=action.get("use_variations", True),
        centroid_alpha=m["centroid_estimator"]["alpha"],
        ensemble_size=action["ensamble_size"],
        pretraining_detach=t.get("pretraining_detach", False),
        checkpoint_steps=tpu.get("remat", False),
        dtype=torch.bfloat16 if tpu.get("compute_dtype") == "bfloat16" else torch.float32,
    )
    return _place(model, device, seed)


def flagship_model(device: DeviceLike = "cuda", dtype: torch.dtype = torch.bfloat16,
                   seed: int = 0, checkpoint_steps: bool = False) -> Caddy:
    """The BAIR-class flagship (``configs/01_bair.yaml``): 256x256 frames,
    main model, hidden 128, 64 state features at 32x32, 7 actions, 2-D
    action variations, observation stacking 1, bf16 compute, soft Gumbel,
    centroid alpha 0.1, one action network."""
    model = Caddy(actions_count=7, action_space_dimension=2, state_features=64,
                  state_resolution=(32, 32), hidden_state_size=128,
                  observation_stacking=1, checkpoint_steps=checkpoint_steps, dtype=dtype)
    return _place(model, device, seed)
