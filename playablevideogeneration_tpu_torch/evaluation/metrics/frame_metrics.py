"""Per-observation frame metrics: MSE, PSNR, motion-masked MSE, SSIM, VGG
cosine similarity, and the Fréchet distance.

Counterpart of
``playablevideogeneration_tpu/evaluation/metrics/frame_metrics.py``.  The
frame metrics take (B, T, H, W, C) tensors in [0, 1] (channels last, as
the loader gives them; the offline evaluation's range) and return (B, T)
per-observation values, on the inputs' device.

SSIM is Wang et al. 2004 with an 11x11 Gaussian window of sigma 1.5 over
valid windows and data range 1, as the reference's piq computes it; the
window is a depthwise ``F.conv2d``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from playablevideogeneration_tpu_torch.models.vgg import Vgg19


def frames_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B*T, C, H, W)."""
    return x.reshape((-1,) + tuple(x.shape[2:])).permute(0, 3, 1, 2)


def mse(reference: torch.Tensor, generated: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) pair -> (B, T) per-observation MSE."""
    return torch.mean((reference - generated) ** 2, dim=(2, 3, 4))


def psnr(reference: torch.Tensor, generated: torch.Tensor,
         max_value: float = 1.0) -> torch.Tensor:
    """(B, T) per-observation PSNR in dB."""
    err = mse(reference, generated)
    return 10.0 * torch.log10((max_value ** 2) / torch.clamp(err, min=1e-12))


def motion_mask(sequence: torch.Tensor, bias: float = 0.0) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, H, W, 1) non-negative weights: the
    absolute frame difference summed over channels, the first one
    repeated for the first frame, plus ``bias``."""
    diff = torch.abs(sequence[:, 1:] - sequence[:, :-1]).sum(dim=-1, keepdim=True)
    return torch.cat([diff[:, 0:1], diff], dim=1) + bias


def motion_masked_mse(reference: torch.Tensor, generated: torch.Tensor,
                      bias: float = 0.0) -> torch.Tensor:
    """MSE weighted by the reference sequence's motion mask, normalised per
    frame."""
    mask = motion_mask(reference, bias)
    err = ((reference - generated) ** 2) * mask
    num = err.sum(dim=(2, 3, 4))
    den = mask.sum(dim=(2, 3, 4)) * reference.shape[-1]
    return num / torch.clamp(den, min=1e-12)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(reference: torch.Tensor, generated: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """(B, T, H, W, C) pair -> (B, T) per-observation SSIM."""
    b, t = reference.shape[:2]
    x, y = frames_nchw(reference), frames_nchw(generated)
    c = x.shape[1]
    window = _gaussian_kernel().to(x.device, x.dtype).expand(c, 1, -1, -1)

    def filtered(z):
        return F.conv2d(z, window, groups=c)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_x, mu_y = filtered(x), filtered(y)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = filtered(x * x) - mu_xx
    sigma_y = filtered(y * y) - mu_yy
    sigma_xy = filtered(x * y) - mu_xy
    ssim_map = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2))
    return ssim_map.mean(dim=(1, 2, 3)).reshape(b, t)


def vgg_cosine_similarity(vgg: Vgg19, reference: torch.Tensor,
                          generated: torch.Tensor) -> torch.Tensor:
    """(B, T) mean over VGG19's 5 feature levels of the cosine similarity
    of the two frames' features."""
    b, t = reference.shape[:2]
    sims = []
    for fx, fy in zip(vgg(frames_nchw(reference)), vgg(frames_nchw(generated))):
        fx, fy = fx.flatten(1), fy.flatten(1)
        num = (fx * fy).sum(-1)
        den = torch.linalg.vector_norm(fx, dim=-1) * torch.linalg.vector_norm(fy, dim=-1)
        sims.append(num / torch.clamp(den, min=1e-12))
    return torch.stack(sims).mean(dim=0).reshape(b, t)


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians, through scipy's sqrtm.

    ``sqrtm`` is called without ``disp``: newer scipy releases removed the
    argument (the card's machine has one), and its result does not depend
    on it."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))
