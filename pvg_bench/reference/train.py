"""The training step in plain PyTorch, float32: CADDY's loss terms, the
VGG19 perceptual loss, the plain or smoothed mutual information and Adam
with L2 decay.

A frozen copy of the port's ``training/losses.py``,
``Trainer.train_step`` (``compute_loss_terms``) and
``training/schedules.py``, without graphs and collectives.  It imports
nothing of the port or of JAX.
"""
from __future__ import annotations

import math
import sys
from typing import List, Optional

import torch
import torch.nn.functional as F

from pvg_bench.reference.model import Caddy, NoiseSource, Vgg19, flatten, resize_bilinear

_EPS = sys.float_info.epsilon
_VARIANCE_FLOOR = 1e-20
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def schedules(config: dict, step: int) -> dict:
    """The step's sequence length, ground-truth frames, Gumbel temperature
    and phase (``step`` counts from 1, as the port's global step after its
    increment)."""
    t = config["training"]
    b = t["batching"]
    frames = min(b["observations_count"], math.floor(
        b["observations_count_start"]
        + (b["observations_count"] - b["observations_count_start"]) * step
        / b["observations_count_steps"]))
    gt = max(t["ground_truth_observations_end"], math.ceil(
        t["ground_truth_observations_start"]
        - (t["ground_truth_observations_start"] - t["ground_truth_observations_end"]) * step
        / t["ground_truth_observations_steps"]))
    temperature = max(t["gumbel_temperature_end"], t["gumbel_temperature_start"]
                      - (t["gumbel_temperature_start"] - t["gumbel_temperature_end"]) * step
                      / t["gumbel_temperature_steps"])
    return dict(frames=frames, gt_init=min(gt, frames - 1), temperature=temperature,
                pretraining=step <= t["pretraining_steps"])


def _perceptual_and_l1(vgg: Vgg19, observations, recon):
    gt = flatten(observations[:, 1:, :3])
    h, w = recon.shape[-2:]
    # The port resizes the L1's ground truth at every resolution, and the
    # perceptual loss's only where the size differs.
    l1 = torch.mean(torch.abs(resize_bilinear(gt, h, w) - flatten(recon)))
    flat_gt = gt if gt.shape[-2:] == (h, w) else resize_bilinear(gt, h, w)
    with torch.no_grad():
        gt_features = vgg(flat_gt)
    total = torch.zeros((), device=recon.device)
    for f_gt, f_rec in zip(gt_features, vgg(flatten(recon))):
        if f_rec.shape[2] and f_rec.shape[3]:
            total = total + torch.mean(torch.abs(f_gt - f_rec))
    return total, l1


def _kl_gaussian(params):
    d = params.shape[-1]
    p = params.reshape(-1, 2, d)
    mean, variance = p[:, 0], p[:, 1]
    kl = 1.0 + torch.log(torch.clamp(variance, min=_VARIANCE_FLOOR)) - mean ** 2 - variance
    return -0.5 * torch.mean(kl.sum(dim=-1))


def _kl_general_gaussian(params, reference, eps: float = 0.05):
    d = params.shape[-1]
    p, q = params.reshape(-1, 2, d), reference.reshape(-1, 2, d)
    mean, variance = p[:, 0], p[:, 1].detach()
    ref_mean, ref_variance = q[:, 0], q[:, 1].detach()
    log_variance = torch.log(torch.clamp(variance, min=_VARIANCE_FLOOR))
    ref_log_variance = torch.log(torch.clamp(ref_variance, min=_VARIANCE_FLOOR))
    variance, ref_variance = torch.clamp(variance, min=eps), torch.clamp(ref_variance, min=eps)
    kl = (ref_log_variance - log_variance - 1.0 + variance / ref_variance
          + (ref_mean - mean) ** 2 / ref_variance)
    return 0.5 * torch.mean(kl.sum(dim=-1))


def _joint(p1, p2):
    dim = p1.shape[-1]
    p = p1.reshape(-1, dim).t() @ p2.reshape(-1, dim)
    p = (p + p.t()) / 2.0
    return p / p.sum()


def _negative_mutual_information(joint, lamb: float):
    marg_r = torch.clamp(joint.sum(dim=1, keepdim=True).expand_as(joint), min=_EPS)
    marg_c = torch.clamp(joint.sum(dim=0, keepdim=True).expand_as(joint), min=_EPS)
    joint = torch.clamp(joint, min=_EPS)
    return -(joint * (torch.log(joint) - lamb * torch.log(marg_r)
                      - lamb * torch.log(marg_c))).sum()


def loss(model: Caddy, vgg: Vgg19, config: dict, observations, noise: NoiseSource,
         schedule: dict, mi_matrix: Optional[torch.Tensor]):
    """(total loss, new MI matrix or None) of one full-phase step."""
    if schedule["pretraining"]:
        raise NotImplementedError("the reference covers the full phase")
    t = config["training"]
    w = t["loss_weights"]
    if t.get("use_motion_weights"):
        raise NotImplementedError("the reference covers the configs without motion weights")
    out = model.forward_full_model(observations, schedule["gt_init"], noise,
                                   schedule["temperature"])
    perceptual, l1 = 0.0, 0.0
    for recon in out["multires"]:
        p, o = _perceptual_and_l1(vgg, observations, recon)
        perceptual, l1 = perceptual + p, l1 + o
    perceptual, l1 = perceptual / len(out["multires"]), l1 / len(out["multires"])
    states_rec = torch.mean((out["states"].detach() - out["reconstructed_states"]) ** 2)
    logits = out["action_logits"].reshape(-1, out["action_logits"].shape[-1])
    entropy = -torch.sum(F.softmax(logits, -1) * F.log_softmax(logits, -1)) / logits.shape[0]
    p_real = F.softmax(out["action_logits"], dim=-1)
    p_recon = F.softmax(out["reconstructed_action_logits"], dim=-1)
    lamb = t.get("action_mutual_information_entropy_lambda", 1.0)
    new_matrix = None
    if mi_matrix is not None:
        alpha = t.get("mutual_information_estimation_alpha", 0.2)
        smoothed = mi_matrix * (1.0 - alpha) + _joint(p_real, p_recon) * alpha
        mi, new_matrix = _negative_mutual_information(smoothed, lamb), smoothed.detach()
    else:
        mi = _negative_mutual_information(_joint(p_real, p_recon), lamb)
    total = (w["reconstruction_loss_lambda"] * l1 + w["perceptual_loss_lambda"] * perceptual
             + w["states_rec_lambda"] * states_rec + w["entropy_lambda"] * entropy
             + w["action_directions_kl_lambda"] * _kl_gaussian(out["dirs_dist"])
             + w["action_mutual_information_lambda"] * mi
             + w["action_state_distribution_kl_lambda"] * _kl_general_gaussian(
                 out["r_states_dist"], out["states_dist"].detach()))
    return total, new_matrix


class Adam:
    """Adam with L2 decay added to the gradient before the moments, eps
    outside the square root (``torch.optim.Adam(weight_decay=...)``)."""

    def __init__(self, params: List[torch.Tensor], lr: float, weight_decay: float):
        self.params, self.lr, self.weight_decay = params, lr, weight_decay
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Applies one update; returns the gradients as the moments took
        them (decay included)."""
        self.count += 1
        b1, b2 = BETAS
        taken = []
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g + self.weight_decay * p
            taken.append(g)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v / (1 - b2 ** self.count)).sqrt_().add_(ADAM_EPS)
            p.addcdiv_(m, denom, value=-self.lr / (1 - b1 ** self.count))
        return taken


def learning_rate(config: dict, update: int) -> float:
    """The rate of update ``update`` (from 0): MultiStepLR's."""
    t = config["training"]
    return t["learning_rate"] * t["lr_gamma"] ** sum(update >= int(m) for m in t["lr_schedule"])


def train_steps(model: Caddy, vgg: Vgg19, config: dict, batches, noise: NoiseSource,
                first_step: int, smooth_mi: bool) -> dict:
    """Trains ``model`` over ``batches`` (each (B, T, 3*stacking, H, W) on
    the model's device) from global step ``first_step``, as the port's
    ``Trainer.train_step`` does.

    :return: ``losses`` per step, ``first_gradients`` (name -> the
        gradient Adam took at the first step), ``first_buffers`` (name ->
        BatchNorm statistic or centroids after it), ``parameters`` (name ->
        value after the last step)
    """
    model.train()
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    actions = config["data"]["actions_count"]
    mi_matrix = (torch.full((actions, actions), 1.0 / actions ** 2, device=params[0].device)
                 if smooth_mi else None)
    adam = Adam(params, config["training"]["learning_rate"], config["training"]["weight_decay"])
    losses, first = [], None
    for k, observations in enumerate(batches):
        schedule = schedules(config, first_step + k)
        total, new_matrix = loss(model, vgg, config, observations, noise, schedule, mi_matrix)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        adam.lr = learning_rate(config, adam.count)
        taken = adam.step(grads)
        if first is None:
            first = dict(zip(names, taken))
            first_buffers = {n: b.detach().clone() for n, b in model.named_buffers()}
        if new_matrix is not None:
            mi_matrix = new_matrix
        losses.append(float(total.detach()))
    return dict(losses=losses, first_gradients=first, first_buffers=first_buffers,
                parameters={n: p.detach().clone() for n, p in zip(names, params)})
