"""CADDY, the playable-video-generation model: the play route.

Counterpart of ``playablevideogeneration_tpu/models/caddy.py``.  This slice
holds E (representation), R (dynamics), D (rendering) and the action
centroids, with ``init_play`` and ``play_step``.  The action networks,
``state_to_hidden`` and the training forwards come with the training slice.

The modules work in NCHW; ``init_play`` and ``play_step`` keep the JAX
package's NHWC layout at their boundary, handing out NHWC views of NCHW
storage so that nothing is copied between steps.
"""
from __future__ import annotations

import itertools
from typing import Tuple

import torch
from torch import nn

from playablevideogeneration_tpu_torch.models.dynamics import (
    ConvDynamicsNetwork,
    DynamicsCarry,
)
from playablevideogeneration_tpu_torch.models.rendering import RenderingNetwork
from playablevideogeneration_tpu_torch.models.representation import RepresentationNetwork
from playablevideogeneration_tpu_torch.utils.device import DeviceLike, resolve_device


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).to(dtype).contiguous()


class Caddy(nn.Module):
    def __init__(self, actions_count: int, action_space_dimension: int,
                 state_features: int, state_resolution: Tuple[int, int],
                 hidden_state_size: int, observation_stacking: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.actions_count = actions_count
        self.action_space_dimension = action_space_dimension
        self.state_features = state_features
        self.state_resolution = tuple(state_resolution)
        self.hidden_state_size = hidden_state_size
        self.observation_stacking = observation_stacking
        self.dtype = dtype
        hs = hidden_state_size
        self.representation_network = RepresentationNetwork(
            3 * observation_stacking, state_features, dtype)
        self.dynamics_network = ConvDynamicsNetwork(
            state_features, actions_count, action_space_dimension, hs,
            self.state_resolution, dtype)
        self.rendering_network = RenderingNetwork(hs, (hs, hs // 2, hs // 4), dtype)
        self.register_buffer("centroids",
                             torch.zeros(actions_count, action_space_dimension))

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
        next_observation = torch.cat([frame, obs[:, :-3]], dim=1)
        carry = tuple((_nhwc(h), _nhwc(c)) for h, c in carry)
        return carry, _nhwc(frame), _nhwc(next_observation)


@torch.no_grad()
def _seeded_init(model: nn.Module, seed: int) -> nn.Module:
    """Fills every parameter and buffer from a generator seeded with
    ``seed``, on the CPU, so a seed gives the same weights on any device:
    conv kernels LeCun-normal, BN scales in [0.5, 1.5], biases, BN means
    and initial LSTM states N(0, 0.1^2), BN variances in [0.5, 2],
    centroids N(0, 1).  The BN statistics are far from (0, 1) on purpose,
    so the normalisation does real work."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    def uniform(shape, low, high):
        return torch.rand(shape, generator=gen) * (high - low) + low

    for name, tensor in itertools.chain(model.named_parameters(), model.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        if tensor.dim() == 4:
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
    return _seeded_init(model, seed).to(device).eval()


def make_model(config: dict, device: DeviceLike = "cuda", seed: int = 0) -> Caddy:
    """Builds the model from a configuration dict (the YAML schema of
    ``configs/*.yaml``), with weights seeded from ``seed``, on ``device``.

    Reads the keys that shape the play route, as the JAX ``make_model``
    reads them, and rejects ``use_ground_truth_actions`` as it does.  The
    action-network and training keys belong to the training slice; the
    ``tpu`` layout knobs (``rendering_subpixel``, ``resize_impl``,
    ``stem_subpixel``, ``fuse_upsample``, ``remat*``) select tap-exact
    rewrites of the plain ops and have no counterpart here.
    """
    m = config["model"]
    if config["training"].get("use_ground_truth_actions"):
        raise NotImplementedError(
            "use_ground_truth_actions during training is not supported by "
            "the selected model")
    bf16 = config.get("tpu", {}).get("compute_dtype") == "bfloat16"
    model = Caddy(
        actions_count=config["data"]["actions_count"],
        action_space_dimension=m["action_network"]["action_space_dimension"],
        state_features=m["representation_network"]["state_features"],
        state_resolution=tuple(m["representation_network"]["state_resolution"]),
        hidden_state_size=m["dynamics_network"]["hidden_state_size"],
        observation_stacking=config["training"]["batching"]["observation_stacking"],
        dtype=torch.bfloat16 if bf16 else torch.float32,
    )
    return _place(model, device, seed)


def flagship_model(device: DeviceLike = "cuda", dtype: torch.dtype = torch.bfloat16,
                   seed: int = 0) -> Caddy:
    """The BAIR-class flagship (``configs/01_bair.yaml``): 256x256 frames,
    main model, hidden 128, 64 state features at 32x32, 7 actions, 2-D
    action variations, observation stacking 1, bf16 compute."""
    model = Caddy(actions_count=7, action_space_dimension=2, state_features=64,
                  state_resolution=(32, 32), hidden_state_size=128,
                  observation_stacking=1, dtype=dtype)
    return _place(model, device, seed)
