"""Loss library.

Counterpart of ``playablevideogeneration_tpu/training/losses.py``.  Images
are indexed channels-first, sequences (B, T, C, H, W) and frames (N, C, H,
W), and stored channels-last, as the model emits them.  The
smoothed mutual-information estimator takes and returns its joint matrix
as explicit state.
"""
from __future__ import annotations

import sys
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from playablevideogeneration_tpu_torch.parallel import mesh
from playablevideogeneration_tpu_torch.utils import tensor_ops as tops

_EPS = sys.float_info.epsilon
# Under this floor a variance's log would be -inf: a posterior sharpened
# until its variance underflows to 0 must not turn the step into NaN.
_VARIANCE_FLOOR = 1e-20


def _align_right(ground_truth: torch.Tensor, reconstructed: torch.Tensor):
    """Right-aligns a length T-1 reconstruction against a length T ground
    truth sequence."""
    t_gt, t_rec = ground_truth.shape[1], reconstructed.shape[1]
    if t_rec != t_gt:
        if t_rec != t_gt - 1:
            raise ValueError(f"Sequence lengths {t_gt} vs {t_rec} are incompatible")
        ground_truth = ground_truth[:, 1:]
    return ground_truth, reconstructed


def states_loss(states: torch.Tensor, reconstructed_states: torch.Tensor) -> torch.Tensor:
    """MSE between state sequences."""
    return torch.mean((states - reconstructed_states) ** 2)


def hidden_states_loss(hidden_states: torch.Tensor,
                       reconstructed_hidden_states: torch.Tensor) -> torch.Tensor:
    """MSE between hidden-state sequences; left-trims a 1-longer
    reconstruction."""
    t, t_rec = hidden_states.shape[1], reconstructed_hidden_states.shape[1]
    if t_rec != t:
        if t_rec - 1 != t:
            raise ValueError(f"Sequence lengths {t} vs {t_rec} are incompatible")
        reconstructed_hidden_states = reconstructed_hidden_states[:, 1:]
    return torch.mean((hidden_states - reconstructed_hidden_states) ** 2)


def observations_loss(observations: torch.Tensor, reconstructed_observations: torch.Tensor,
                      weight_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1 loss on the current frame of each observation, the ground truth
    resized (antialiased, as ``jax.image.resize``) to the reconstruction's
    resolution; with a weight mask, normalised per frame.

    :param observations: (B, T, 3*stacking, H, W) in [-1, 1]
    :param reconstructed_observations: (B, T|T-1, 3, h, w)
    :param weight_mask: optional (B, T, 1, H', W')
    """
    observations, reconstructed_observations = _align_right(
        observations[:, :, :3], reconstructed_observations)
    h, w = reconstructed_observations.shape[-2:]
    flat_obs = tops.resize_bilinear(tops.flatten(observations), h, w)
    flat_rec = tops.flatten(reconstructed_observations)
    if weight_mask is None:
        return torch.mean(torch.abs(flat_obs - flat_rec))
    if weight_mask.shape[1] != reconstructed_observations.shape[1]:
        weight_mask = weight_mask[:, 1:]
    flat_mask = tops.resize_bilinear(tops.flatten(weight_mask), h, w)
    per_frame = (torch.abs(flat_obs - flat_rec) * flat_mask).sum(dim=(2, 3))  # (N, 3)
    denom = flat_mask.sum(dim=(2, 3)) * 3.0  # (N, 1), the mask broadcast over channels
    return torch.mean(per_frame / denom)


def kl_divergence_categorical(input_logits: torch.Tensor,
                              target_logits: torch.Tensor) -> torch.Tensor:
    """KL between two categorical logit sets, batchmean reduction."""
    a = input_logits.shape[-1]
    p_log = F.log_softmax(input_logits.reshape(-1, a), dim=-1)
    q = F.softmax(target_logits.reshape(-1, a), dim=-1)
    q_log = F.log_softmax(target_logits.reshape(-1, a), dim=-1)
    return torch.sum(q * (q_log - p_log)) / p_log.shape[0]


def kl_gaussian_divergence(distribution_parameters: torch.Tensor) -> torch.Tensor:
    """KL(diag Gaussian || N(0, 1)) from (mean, variance) pairs, in f32."""
    d = distribution_parameters.shape[-1]
    p = distribution_parameters.reshape(-1, 2, d).float()
    mean, variance = p[:, 0], p[:, 1]
    kl = 1.0 + torch.log(torch.clamp(variance, min=_VARIANCE_FLOOR)) - mean ** 2 - variance
    return -0.5 * torch.mean(kl.sum(dim=-1))


def kl_general_gaussian_divergence(distribution_parameters: torch.Tensor,
                                   reference_distribution_parameters: torch.Tensor,
                                   eps: float = 0.05) -> torch.Tensor:
    """KL between two diagonal Gaussians, in f32; both variances detached
    and clamped at ``eps`` where they divide."""
    d = distribution_parameters.shape[-1]
    p = distribution_parameters.reshape(-1, 2, d).float()
    q = reference_distribution_parameters.reshape(-1, 2, d).float()
    mean, variance = p[:, 0], p[:, 1].detach()
    ref_mean, ref_variance = q[:, 0], q[:, 1].detach()
    log_variance = torch.log(torch.clamp(variance, min=_VARIANCE_FLOOR))
    ref_log_variance = torch.log(torch.clamp(ref_variance, min=_VARIANCE_FLOOR))
    variance = torch.clamp(variance, min=eps)
    ref_variance = torch.clamp(ref_variance, min=eps)
    kl = (ref_log_variance - log_variance - 1.0 + variance / ref_variance
          + (ref_mean - mean) ** 2 / ref_variance)
    return 0.5 * torch.mean(kl.sum(dim=-1))


def entropy_logits(logits: torch.Tensor) -> torch.Tensor:
    """Mean entropy of categorical logits."""
    flat = logits.reshape(-1, logits.shape[-1])
    return -torch.sum(F.softmax(flat, dim=-1) * F.log_softmax(flat, dim=-1)) / flat.shape[0]


def entropy_probabilities(probabilities: torch.Tensor) -> torch.Tensor:
    """Mean entropy of probability vectors; 0 log 0 = 0, so one-hot inputs
    give 0."""
    flat = probabilities.reshape(-1, probabilities.shape[-1])
    return -torch.sum(torch.xlogy(flat, flat)) / flat.shape[0]


def joint_probability_matrix(distribution_1: torch.Tensor,
                             distribution_2: torch.Tensor) -> torch.Tensor:
    """Symmetrised, normalised (A, A) joint probability matrix of two sets
    of categorical samples; in a data-parallel step the global batch's, the
    unnormalised joint summed over the ranks before the normalisation."""
    dim = distribution_1.shape[-1]
    p = mesh.all_reduce_sum(distribution_1.reshape(-1, dim).t() @ distribution_2.reshape(-1, dim))
    p = (p + p.t()) / 2.0
    return p / p.sum()


def mutual_information_from_joint(joint: torch.Tensor, lamb: float = 1.0,
                                  eps: float = _EPS) -> torch.Tensor:
    """-MI of a joint probability matrix; ``lamb`` scales the marginal
    entropy terms."""
    marg_r = joint.sum(dim=1, keepdim=True).expand_as(joint)
    marg_c = joint.sum(dim=0, keepdim=True).expand_as(joint)
    joint = torch.clamp(joint, min=eps)
    marg_r = torch.clamp(marg_r, min=eps)
    marg_c = torch.clamp(marg_c, min=eps)
    mi = joint * (torch.log(joint) - lamb * torch.log(marg_r) - lamb * torch.log(marg_c))
    return -mi.sum()


def mutual_information_loss(distribution_1: torch.Tensor, distribution_2: torch.Tensor,
                            lamb: float = 1.0) -> torch.Tensor:
    """IIC-style -MI between the action distributions of the real and the
    reconstructed sequences."""
    return mutual_information_from_joint(
        joint_probability_matrix(distribution_1, distribution_2), lamb)


def smooth_mutual_information_loss(distribution_1: torch.Tensor,
                                   distribution_2: torch.Tensor,
                                   estimated_matrix: torch.Tensor, alpha: float,
                                   lamb: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """MI loss on an EMA-smoothed joint matrix: returns (loss, new matrix,
    detached).  The old matrix enters detached; gradients flow into the
    batch's ``alpha``-weighted share."""
    current = joint_probability_matrix(distribution_1, distribution_2)
    smoothed = estimated_matrix.detach() * (1.0 - alpha) + current * alpha
    return mutual_information_from_joint(smoothed, lamb), smoothed.detach()


def init_mi_matrix(actions_count: int, device: Optional[torch.device] = None) -> torch.Tensor:
    """Uniform independent (A, A) joint matrix, f32."""
    return torch.full((actions_count, actions_count), 1.0 / (actions_count * actions_count),
                      device=device)


def perceptual_loss(vgg: Callable[[torch.Tensor], List[torch.Tensor]],
                    observations: torch.Tensor, reconstructed_observations: torch.Tensor,
                    weight_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Sum over VGG19's 5 feature levels of the L1 distance between the
    ground truth's and the reconstruction's features.

    :param vgg: (N, 3, H, W) -> list of 5 feature maps (``models.vgg.Vgg19``)
    :param observations: (B, T, 3*stacking, H, W) ground truth in [-1, 1]
    :param reconstructed_observations: (B, T|T-1, 3, h, w)
    :param weight_mask: optional (B, T, 1, H', W')
    :return: (total, per-level losses); a level whose map is empty adds 0
    """
    gt, rec = _align_right(observations[:, :, :3], reconstructed_observations)
    h, w = rec.shape[-2:]
    flat_gt = tops.flatten(gt).detach()
    if flat_gt.shape[-2:] != (h, w):
        flat_gt = tops.resize_bilinear(flat_gt, h, w)
    with torch.no_grad():
        gt_features = vgg(flat_gt)
    rec_features = vgg(tops.flatten(rec))

    if weight_mask is not None and weight_mask.shape[1] != rec.shape[1]:
        weight_mask = weight_mask[:, 1:]
    flat_mask = tops.flatten(weight_mask) if weight_mask is not None else None

    total = torch.zeros((), device=rec.device)
    singles = []
    for f_gt, f_rec in zip(gt_features, rec_features):
        if f_rec.shape[2] == 0 or f_rec.shape[3] == 0:
            singles.append(torch.zeros((), device=rec.device))
            continue
        if flat_mask is None:
            level = torch.mean(torch.abs(f_gt - f_rec))
        else:
            fc, fh, fw = f_rec.shape[1:]
            mask = tops.resize_bilinear(flat_mask, fh, fw)
            per_image = (torch.abs(f_gt - f_rec) * mask).sum(dim=(1, 2, 3))
            level = torch.mean(per_image / (mask.sum(dim=(1, 2, 3)) * fc))
        total = total + level
        singles.append(level)
    return total, singles


def motion_weight_mask(observations: torch.Tensor, reconstructed_observations: torch.Tensor,
                       weight_bias: float = 0.0) -> torch.Tensor:
    """|frame difference of the ground truth| + |frame difference of the
    reconstruction|, summed over channels, plus ``weight_bias``, with a
    constant first element; detached.

    :return: (B, T, 1, H, W)
    """
    observations = observations.detach()[:, :, :3]
    rec = reconstructed_observations.detach()
    if rec.shape[1] != observations.shape[1]:
        rec = tops.cat([observations[:, 0:1], rec.to(observations.dtype)], dim=1)
    mask = (torch.abs(observations[:, 1:] - observations[:, :-1])
            + torch.abs(rec[:, 1:] - rec[:, :-1]))
    mask = mask.sum(dim=2, keepdim=True) + weight_bias
    return torch.cat([torch.ones_like(mask[:, 0:1]), mask], dim=1)


def sequence_loss(loss_fn: Callable, ground_truth_sequence: torch.Tensor,
                  reconstructed_sequence: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``loss_fn`` at each position of a sequence, a length T-1
    reconstruction right-aligned against the length T ground truth; a
    ``loss_fn`` that returns a tuple gives its first element.

    :return: (mean over the reconstructed positions, (T,) per-position
        losses, position 0 zero when the reconstruction is one shorter)
    """
    t_gt, t_rec = ground_truth_sequence.shape[1], reconstructed_sequence.shape[1]
    offset = t_gt - t_rec
    if offset not in (0, 1):
        raise ValueError(f"Sequence lengths {t_gt} vs {t_rec} are incompatible")
    terms = [torch.zeros((), device=reconstructed_sequence.device)] * offset
    for i in range(t_rec):
        value = loss_fn(ground_truth_sequence[:, i + offset:i + offset + 1],
                        reconstructed_sequence[:, i:i + 1])
        terms.append(value[0] if isinstance(value, tuple) else value)
    terms = torch.stack([t.float() for t in terms])
    return terms[offset:].mean(), terms
