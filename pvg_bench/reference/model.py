"""CADDY's main model in plain PyTorch, float32, for the benchmark's checks.

A frozen copy of the port's plain paths (``models/layers.py``,
``representation.py``, ``action.py``, ``dynamics.py``, ``rendering.py``,
``centroids.py``, ``gumbel.py`` and ``caddy.py``), stripped of the CUDA
kernels, the captured graphs, the data- and tensor-parallel collectives and
the compute-dtype casts.  The module and parameter names are the port's,
so one state dict loads into both.  Every convolution and dense layer
takes its operands through a ``Precision``: the reference runs in float32,
its control (the next precision below the configuration's bfloat16) in
fp8.  It imports nothing of the port or of JAX.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-5
MOMENTUM = 0.9
NEGATIVE_SLOPE = 0.2
GUMBEL_EPS = 1e-20
FP8_MAX = 448.0  # the largest finite float8_e4m3fn


class Precision:
    """The operands and the result of every convolution and dense layer:
    float32 as they are, or with ``fp8`` each rounded to float8_e4m3fn
    under a per-tensor scale that maps its largest magnitude to 448, the
    gradient passing straight through.  That puts fp8 where the bfloat16
    program holds bfloat16: in the products' inputs and in the activations
    between layers (the step from bfloat16 that would tempt a later
    change)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x).detach()


FLOAT32 = Precision()

# (kind, shape) -> noise: "uniform" U[0, 1) or "normal" N(0, 1), f32.
NoiseSource = Callable[[str, Tuple[int, ...]], torch.Tensor]


def generator_noise(generator: torch.Generator) -> NoiseSource:
    """Noise drawn from ``generator`` on its device, in the port's order
    and shapes, so the same seed gives the same draws."""
    def draw(kind: str, shape) -> torch.Tensor:
        fn = torch.rand if kind == "uniform" else torch.randn
        return fn(tuple(shape), generator=generator, device=generator.device)
    return draw


def zero_noise(device) -> NoiseSource:
    """Constant noise (U = 0.5, N = 0), for counting operations on meta
    tensors."""
    def draw(kind: str, shape) -> torch.Tensor:
        value = 0.5 if kind == "uniform" else 0.0
        return torch.full(tuple(shape), value, device=device)
    return draw


def flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


def fold(x: torch.Tensor, second_dim: int) -> torch.Tensor:
    return x.reshape((x.shape[0] // second_dim, second_dim) + tuple(x.shape[1:]))


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``jax.image.resize(method='linear')``: half-pixel centres and the
    antialiasing triangle filter when shrinking."""
    lead = x.shape[:-3]
    flat = x.reshape((-1,) + tuple(x.shape[-3:]))
    out = F.interpolate(flat, size=(height, width), mode="bilinear", align_corners=False,
                        antialias=True)
    return out.reshape(tuple(lead) + tuple(out.shape[1:]))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, NEGATIVE_SLOPE)


def avg_pool(x: torch.Tensor, factor: int) -> torch.Tensor:
    return x if factor == 1 else F.avg_pool2d(x, factor)


def upsample_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    return F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=False)


class Conv2d(nn.Conv2d):
    """Stride-1 convolution with SAME padding for an odd kernel."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int, bias: bool,
                 precision: Precision):
        super().__init__(in_planes, out_planes, kernel_size, padding=kernel_size // 2,
                         bias=bias)
        self.precision = precision

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.precision(F.conv2d(self.precision(x), self.precision(self.weight),
                                       self.bias, padding=self.padding))


class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, precision: Precision):
        super().__init__(in_features, out_features)
        self.precision = precision

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.precision(F.linear(self.precision(x), self.precision(self.weight),
                                       self.bias))


class BatchNorm(nn.Module):
    """Affine BatchNorm, eps 1e-5: batch statistics in training (variance
    E[x^2] - E[x]^2 clipped at 0, the biased variance folded into the
    running statistics at momentum 0.9), running statistics in evaluation;
    an optional LeakyReLU after it."""

    def __init__(self, features: int, activation: Optional[str] = None):
        super().__init__()
        self.activation = activation
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(MOMENTUM * self.running_mean + (1 - MOMENTUM) * mean)
                self.running_var.copy_(MOMENTUM * self.running_var + (1 - MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + EPS) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return leaky_relu(y) if self.activation == "leaky_relu" else y


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, downsample_factor: int,
                 precision: Precision):
        super().__init__()
        self.downsample_factor = downsample_factor
        self.conv1 = Conv2d(in_planes, out_planes, 3, False, precision)
        self.bn1 = BatchNorm(out_planes, activation="leaky_relu")
        self.conv2 = Conv2d(out_planes, out_planes, 3, False, precision)
        self.bn2 = BatchNorm(out_planes)
        self.has_shortcut = downsample_factor != 1 or in_planes != out_planes
        if self.has_shortcut:
            self.shortcut_conv = Conv2d(in_planes, out_planes, 1, False, precision)
            self.shortcut_bn = BatchNorm(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1(avg_pool(self.conv1(x), self.downsample_factor))
        out = self.bn2(self.conv2(out))
        identity = x
        if self.has_shortcut:
            identity = self.shortcut_bn(avg_pool(self.shortcut_conv(x), self.downsample_factor))
        return leaky_relu(out + identity)


class SameBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, downsample_factor: int,
                 precision: Precision):
        super().__init__()
        self.downsample_factor = downsample_factor
        self.conv1 = Conv2d(in_planes, out_planes, 3, False, precision)
        self.bn1 = BatchNorm(out_planes, activation="leaky_relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn1(avg_pool(self.conv1(x), self.downsample_factor))


class UpBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, late_upscaling: bool,
                 precision: Precision):
        super().__init__()
        self.late_upscaling = late_upscaling
        self.conv = Conv2d(in_planes, out_planes, 3, False, precision)
        self.norm = BatchNorm(out_planes, activation="leaky_relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.late_upscaling:
            x = upsample_bilinear(x, 2)
        x = self.norm(self.conv(x))
        return upsample_bilinear(x, 2) if self.late_upscaling else x


class FinalBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, kernel_size: int,
                 precision: Precision):
        super().__init__()
        self.conv = Conv2d(in_planes, out_planes, kernel_size, True, precision)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.conv(x))


def channelwise_concat(tensors: List[torch.Tensor]) -> torch.Tensor:
    spatial = next(t for t in tensors if t.dim() == 4)
    height, width = spatial.shape[2], spatial.shape[3]
    return torch.cat([t if t.dim() == 4 else t[:, :, None, None].expand(-1, -1, height, width)
                      for t in tensors], dim=1)


def lstm_gates(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ConvLSTM gate update (i, f, o, g order): K1's function, whose
    gradient autograd takes (K2's)."""
    i, f, o, g = gates.chunk(4, dim=1)
    new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(new_c), new_c


class ConvLSTMCell(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, precision: Precision):
        super().__init__()
        self.gates = Conv2d(in_planes + out_planes, 4 * out_planes, 3, True, precision)

    def forward(self, carry, x):
        h, c = carry
        new_h, new_c = lstm_gates(self.gates(torch.cat([x, h], dim=1)), c)
        return (new_h, new_c), new_h


class ConvLSTM(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, height: int, width: int,
                 precision: Precision):
        super().__init__()
        self.cell = ConvLSTMCell(in_planes, out_planes, precision)
        self.initial_hidden_state = nn.Parameter(torch.zeros(out_planes, height, width))
        self.initial_cell_state = nn.Parameter(torch.zeros(out_planes, height, width))

    def init_carry(self, batch_size: int):
        return tuple(s[None].repeat(batch_size, 1, 1, 1)
                     for s in (self.initial_hidden_state, self.initial_cell_state))

    def forward(self, carry, x):
        return self.cell(carry, x)


class RepresentationNetwork(nn.Module):
    """E: conv3x3(16) + avgpool2 + BN + lrelu, six residual blocks to
    state_features + 1 channels at /8; the last channel is a sigmoid
    attention map."""

    def __init__(self, in_channels: int, state_features: int, precision: Precision):
        super().__init__()
        self.conv1 = Conv2d(in_channels, 16, 3, False, precision)
        self.bn1 = BatchNorm(16, activation="leaky_relu")
        specs = [(16, 1), (32, 2), (32, 1), (state_features, 2), (state_features, 1),
                 (state_features + 1, 1)]
        planes_in = 16
        for i, (planes, down) in enumerate(specs):
            self.add_module(f"res{i}", ResidualBlock(planes_in, planes, down, precision))
            planes_in = planes
        self.blocks = len(specs)

    def forward(self, observations):
        x = self.bn1(avg_pool(self.conv1(observations), 2))
        for i in range(self.blocks):
            x = getattr(self, f"res{i}")(x)
        return x[:, :-1], torch.sigmoid(x[:, -1:])


class ActionNetwork(nn.Module):
    def __init__(self, state_features: int, actions_count: int, action_space_dimension: int,
                 precision: Precision):
        super().__init__()
        sf = state_features
        self.res0 = ResidualBlock(sf, 2 * sf, 2, precision)
        self.res1 = ResidualBlock(2 * sf, 2 * sf, 1, precision)
        self.mean_fc = Linear(2 * sf, action_space_dimension, precision)
        self.variance_fc = Linear(2 * sf, action_space_dimension, precision)
        self.final_fc = Linear(action_space_dimension, actions_count, precision)

    def forward(self, noise: NoiseSource, states, states_attention):
        t = states.shape[1]
        x = self.res1(self.res0(flatten(states * states_attention))).mean(dim=(2, 3))
        mean = self.mean_fc(x)
        variance = torch.abs(self.variance_fc(x))
        states_distribution = torch.stack([mean, variance], dim=1)
        sampled_states = noise("normal", mean.shape) * torch.sqrt(variance) + mean
        mean_seq, var_seq = fold(mean, t), fold(variance, t)
        directions_mean = mean_seq[:, 1:] - mean_seq[:, :-1]
        directions_variance = var_seq[:, 1:] + var_seq[:, :-1]
        directions_distribution = torch.stack([directions_mean, directions_variance], dim=2)
        sampled_directions = (noise("normal", directions_mean.shape)
                              * torch.sqrt(directions_variance) + directions_mean)
        logits = self.final_fc(flatten(sampled_directions))
        return (fold(logits, t - 1), directions_distribution, sampled_directions,
                fold(states_distribution, t), fold(sampled_states, t))


class ConvDynamicsNetwork(nn.Module):
    def __init__(self, state_features: int, actions_count: int, action_space_dimension: int,
                 hidden_state_size: int, state_resolution, precision: Precision):
        super().__init__()
        h, w = state_resolution
        hs = hidden_state_size
        extra = actions_count + action_space_dimension
        self.lstm0 = ConvLSTM(state_features + extra, hs, h, w, precision)
        self.bn0 = BatchNorm(hs)
        self.same0 = SameBlock(hs + extra, 2 * hs, 2, precision)
        self.lstm1 = ConvLSTM(2 * hs + extra, 2 * hs, h // 2, w // 2, precision)
        self.bn1 = BatchNorm(2 * hs)
        self.up0 = UpBlock(2 * hs + extra, hs, True, precision)
        self.lstm2 = ConvLSTM(hs + extra, hs, h, w, precision)
        self.bn2 = BatchNorm(hs)
        self.same1 = SameBlock(hs + extra, hs, 1, precision)

    def init_carry(self, batch_size: int):
        return (self.lstm0.init_carry(batch_size), self.lstm1.init_carry(batch_size),
                self.lstm2.init_carry(batch_size))

    def forward(self, carry, states, actions, variations):
        c0, c1, c2 = carry
        c0, x = self.lstm0(c0, channelwise_concat([states, actions, variations]))
        x = self.same0(channelwise_concat([self.bn0(x), actions, variations]))
        c1, x = self.lstm1(c1, channelwise_concat([x, actions, variations]))
        x = self.up0(channelwise_concat([self.bn1(x), actions, variations]))
        c2, x = self.lstm2(c2, channelwise_concat([x, actions, variations]))
        x = self.same1(channelwise_concat([self.bn2(x), actions, variations]))
        return (c0, c1, c2), x


class RenderingNetwork(nn.Module):
    """D: three bilinear x2 stages of widths (hs, hs/2, hs/4), each followed
    by a conv + tanh frame (kernels 3, 3, 7); frames high-res first."""

    def __init__(self, in_planes: int, widths, precision: Precision):
        super().__init__()
        self.stages = len(widths)
        for i, (width, kernel) in enumerate(zip(widths, (3, 3, 7))):
            self.add_module(f"up{i}", UpBlock(in_planes, width, False, precision))
            if i < self.stages - 1:
                self.add_module(f"res{i}", ResidualBlock(width, width, 1, precision))
            self.add_module(f"final{i}", FinalBlock(width, 3, kernel, precision))
            in_planes = width

    def forward(self, hidden_states):
        x, outputs = hidden_states, []
        for i in range(self.stages):
            x = getattr(self, f"up{i}")(x)
            if i < self.stages - 1:
                x = getattr(self, f"res{i}")(x)
            outputs.append(getattr(self, f"final{i}")(x))
        outputs.reverse()
        return outputs[0], outputs


def to_uint8(frame: torch.Tensor) -> torch.Tensor:
    """A frame in [-1, 1] as display bytes, truncated as the port truncates."""
    return ((frame.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)


class Caddy(nn.Module):
    """The main model of ``configs/01_bair.yaml`` and ``03_tennis.yaml``
    (one action network, soft Gumbel, variations on)."""

    def __init__(self, config: dict, precision: Precision = FLOAT32):
        super().__init__()
        m, t = config["model"], config["training"]
        action = m["action_network"]
        if action["ensamble_size"] != 1 or action["hard_gumbel"] or not action["use_gumbel"]:
            raise NotImplementedError("the reference covers one soft-Gumbel action network")
        self.actions_count = config["data"]["actions_count"]
        self.action_space_dimension = action["action_space_dimension"]
        self.observation_stacking = t["batching"]["observation_stacking"]
        self.centroid_alpha = m["centroid_estimator"]["alpha"]
        sf = m["representation_network"]["state_features"]
        hs = m["dynamics_network"]["hidden_state_size"]
        self.representation_network = RepresentationNetwork(
            3 * self.observation_stacking, sf, precision)
        self.action_network_0 = ActionNetwork(sf, self.actions_count,
                                              self.action_space_dimension, precision)
        self.dynamics_network = ConvDynamicsNetwork(
            sf, self.actions_count, self.action_space_dimension, hs,
            tuple(m["representation_network"]["state_resolution"]), precision)
        self.rendering_network = RenderingNetwork(hs, (hs, hs // 2, hs // 4), precision)
        self.state_to_hidden = Conv2d(sf, hs, 3, True, precision)
        self.register_buffer("centroids",
                             torch.zeros(self.actions_count, self.action_space_dimension))

    # Play.

    def play_step(self, carry, window, action_onehot, variation):
        """One interactive step on NCHW tensors: (carry, frame (1, 3, H, W),
        the next window, newest frame first)."""
        state, _ = self.representation_network(window)
        carry, hidden = self.dynamics_network(carry, state, action_onehot, variation)
        frame, _ = self.rendering_network(hidden)
        return carry, frame, torch.cat([frame, window[:, :-3]], dim=1)

    # Training.

    def forward_full_model(self, observations, gt_init: int, noise: NoiseSource,
                           gumbel_temperature: float) -> dict:
        """The autoregressive training forward with teacher forcing on the
        first ``gt_init`` frames; the centroids are updated first, in
        training mode."""
        b, t = observations.shape[:2]
        states_flat, attention_flat = self.representation_network(flatten(observations))
        states, attention = fold(states_flat, t), fold(attention_flat, t)
        logits, dirs_dist, sampled_dirs, states_dist, _ = self.action_network_0(
            noise, states, attention)
        flat_logits = flatten(logits)
        flat_log_probs = F.log_softmax(flat_logits, dim=-1)
        flat_probs = F.softmax(flat_logits, dim=-1)
        if self.training:
            with torch.no_grad():
                k, d = self.centroids.shape
                means = flatten(dirs_dist)[:, 0]
                estimate = (flat_probs.t() @ means) / flat_probs.sum(dim=0)[:, None]
                self.centroids.copy_(self.centroids * (1.0 - self.centroid_alpha)
                                     + estimate * self.centroid_alpha)
        centroids = self.centroids.clone()
        u = noise("uniform", flat_log_probs.shape)
        gumbel = -torch.log(-torch.log(u + GUMBEL_EPS) + GUMBEL_EPS)
        flat_samples = F.softmax((flat_log_probs + gumbel) / gumbel_temperature, dim=-1)
        flat_dirs = flatten(sampled_dirs)
        flat_variations = flat_dirs * flat_samples.sum(dim=-1, keepdim=True) \
            - flat_samples @ centroids
        action = fold(flat_samples, t - 1)
        variation = fold(flat_variations, t - 1)

        carry = self.dynamics_network.init_carry(b)
        window, cur_state = observations[:, 0], states[:, 0]
        recons, next_states, next_atts, hiddens = [], [], [], []
        for i in range(t - 1):
            carry, hidden = self.dynamics_network(carry, cur_state, action[:, i],
                                                  variation[:, i])
            recon_full, recon = self.rendering_network(hidden)
            is_gt = i + 1 < gt_init
            window = observations[:, i + 1] if is_gt else torch.cat(
                [recon_full, window[:, :-3]], dim=1)
            # Re-encoded on ground-truth steps too, so the BatchNorm
            # statistics see what the port's see.
            comp_state, comp_att = self.representation_network(window)
            cur_state = states[:, i + 1] if is_gt else comp_state
            next_atts.append(attention[:, i + 1] if is_gt else comp_att)
            recons.append(recon)
            next_states.append(cur_state)
            hiddens.append(hidden)
        multires = [torch.stack(level, dim=1) for level in zip(*recons)]
        reconstructed_states = torch.cat([states[:, 0:1], torch.stack(next_states, dim=1)], 1)
        complete_attention = torch.cat([attention[:, 0:1], torch.stack(next_atts, dim=1)], 1)
        r_logits, r_dirs_dist, _, r_states_dist, _ = self.action_network_0(
            noise, reconstructed_states, complete_attention)
        return dict(multires=multires, states=states, reconstructed_states=reconstructed_states,
                    action_logits=logits, dirs_dist=dirs_dist, states_dist=states_dist,
                    reconstructed_action_logits=r_logits, r_states_dist=r_states_dist)


VGG19_PLAN = [(64, False), (64, False), (128, True), (128, False), (256, True), (256, False),
              (256, False), (256, False), (512, True), (512, False), (512, False),
              (512, False), (512, True)]
VGG19_SLICES = (0, 2, 4, 8, 12)


class Vgg19(nn.Module):
    """VGG19's convolutions to relu5_1, the 5 slices after relu1_1 ...
    relu5_1, frozen; frames in [-1, 1] fed unnormalised."""

    def __init__(self, precision: Precision = FLOAT32):
        super().__init__()
        in_planes = 3
        for i, (channels, _) in enumerate(VGG19_PLAN):
            self.add_module(f"conv{i}", Conv2d(in_planes, channels, 3, True, precision))
            in_planes = channels
        self.requires_grad_(False)

    def forward(self, x):
        outputs = []
        for i, (channels, pool_before) in enumerate(VGG19_PLAN):
            if pool_before:
                if x.shape[2] < 2 or x.shape[3] < 2:
                    x = x.new_zeros((x.shape[0], x.shape[1], x.shape[2] // 2, x.shape[3] // 2))
                else:
                    x = F.max_pool2d(x, 2)
            x = (F.relu(getattr(self, f"conv{i}")(x)) if x.shape[2] and x.shape[3]
                 else x.new_zeros((x.shape[0], channels) + tuple(x.shape[2:])))
            if i in VGG19_SLICES:
                outputs.append(x)
        return outputs
