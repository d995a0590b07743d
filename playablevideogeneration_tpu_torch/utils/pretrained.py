"""Pretrained metric backbones: weight files and wiring.

Counterpart of ``playablevideogeneration_tpu/utils/pretrained.py``: the
VGG19 of the perceptual loss (the trainer's, in the model's dtype, and the
in-training evaluator's, in f32) and the offline evaluation's backbones:
VGG19 and LPIPS, the FID Inception, its classifier head for the Inception
Score, and the FVD I3D.  The port reads the same ``.npz`` files as the JAX
package (flax names, HWIO kernels, written by
``tools/convert_weights.py``), so weights converted once serve both.

Each backbone's file is, in order: the config's
``tpu.pretrained_weights.<name>``; ``<dir>/<canonical file name>`` with
``<dir>`` the config's ``tpu.pretrained_weights_dir`` or the environment's
``PVG_PRETRAINED_WEIGHTS``; otherwise none, and the evaluator records a
``*_unavailable`` marker (VGG19 falls back to seeded random weights).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from playablevideogeneration_tpu_torch.models.vgg import Vgg19, make_vgg
from playablevideogeneration_tpu_torch.utils.device import DeviceLike, resolve_device
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables

# Canonical file names inside a pretrained-weights directory.
WEIGHT_FILES = {
    "vgg19": "vgg19.npz",
    "fid_inception": "fid_inception.npz",
    "i3d": "i3d.npz",
    "lpips_lin": "lpips_lin.npz",
    "frcnn": "frcnn.npz",
}
# The seed of the random VGG19 when no pretrained weights are found.
RANDOM_VGG_SEED = 97


def save_variables_npz(variables: Dict, path: str) -> None:
    """Writes a variables tree ({collection: nested dict of arrays}) as an
    ``.npz`` with '/'-joined keys, the collection first."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix: str, tree: Dict):
        for k, v in tree.items():
            key = f"{prefix}/{k}"
            if isinstance(v, dict):
                walk(key, v)
            else:
                flat[key] = np.asarray(v)

    for collection in variables:
        walk(collection, variables[collection])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_variables_npz(path: str) -> Dict:
    """Inverse of :func:`save_variables_npz`."""
    variables: Dict = {}
    with np.load(path) as data:
        for key, value in data.items():
            parts = key.split("/")
            node = variables
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
    return variables


def find_weights(config, name: str) -> Optional[str]:
    """The weight file of backbone ``name``, or None."""
    tpu = config.get("tpu", {}) if isinstance(config, dict) else {}
    explicit = (tpu.get("pretrained_weights") or {}).get(name)
    if explicit:
        if not os.path.isfile(explicit):
            raise FileNotFoundError(
                f"Configured tpu.pretrained_weights.{name} = '{explicit}' not found")
        return explicit
    directory = tpu.get("pretrained_weights_dir") or os.environ.get("PVG_PRETRAINED_WEIGHTS")
    if directory:
        candidate = os.path.join(directory, WEIGHT_FILES[name])
        if os.path.isfile(candidate):
            return candidate
    return None


def get_vgg_variables(config, logger=None) -> Tuple[Optional[Dict], bool]:
    """(VGG19 variables tree, True) from the converted weights, or (None,
    False) when there are none."""
    path = find_weights(config, "vgg19")
    if path is None:
        return None, False
    if logger is not None:
        logger.print(f"- Loading pretrained VGG19 weights from {path}")
    return load_variables_npz(path), True


def make_metric_vgg(vgg_variables: Optional[Dict], device: DeviceLike = "cuda") -> Vgg19:
    """The metrics' f32 VGG19 on ``device``: the given variables tree, or
    seeded random weights when it is None."""
    if vgg_variables is None:
        return make_vgg(device, torch.float32, RANDOM_VGG_SEED)
    return load_jax_variables(Vgg19(), vgg_variables).to(resolve_device(device)).eval()


def get_lpips_fn(config, logger=None, vgg_variables: Optional[Dict] = None,
                 vgg_pretrained: Optional[bool] = None, device: DeviceLike = "cuda"
                 ) -> Optional[Any]:
    """LPIPS on ``device`` when both the pretrained VGG19 and the linear
    heads are found, else None."""
    from playablevideogeneration_tpu_torch.evaluation.metrics import lpips as lpips_lib

    lin_path = find_weights(config, "lpips_lin")
    if vgg_variables is None:
        vgg_variables, vgg_pretrained = get_vgg_variables(config)
    if lin_path is None or not vgg_pretrained:
        return None
    if logger is not None:
        logger.print(f"- Loading LPIPS linear heads from {lin_path}")
    heads = lpips_lib.load_lpips_linear_weights(lin_path)
    return lpips_lib.make_lpips_fn(make_metric_vgg(vgg_variables, device), heads)


def _inception_variables(config, logger=None) -> Optional[Dict]:
    path = find_weights(config, "fid_inception")
    if path is None:
        return None
    if logger is not None:
        logger.print(f"- Loading FID InceptionV3 weights from {path}")
    return load_variables_npz(path)


def get_fid_extractor(config, logger=None, variables: Optional[Dict] = None,
                      device: DeviceLike = "cuda") -> Optional[Any]:
    """The FID's pool3 extractor on ``device``, or None without weights."""
    from playablevideogeneration_tpu_torch.evaluation.metrics import inception

    if variables is None:
        variables = _inception_variables(config, logger)
    if variables is None:
        return None
    return inception.make_fid_extractor(variables, device)


def get_class_probability_fn(config, logger=None, variables: Optional[Dict] = None,
                             device: DeviceLike = "cuda") -> Optional[Any]:
    """The Inception classifier (for the Inception Score) on ``device``,
    when the FID checkpoint carries its ``fc`` head
    (``tools/convert_weights.py`` keeps it), else None."""
    from playablevideogeneration_tpu_torch.evaluation.metrics import inception

    if variables is None:
        variables = _inception_variables(config, logger)
    if variables is None or "fc" not in variables.get("params", {}):
        return None
    return inception.make_class_probability_fn(variables, device)


def get_fvd_embedder(config, logger=None, device: DeviceLike = "cuda") -> Optional[Any]:
    """The FVD's I3D embedder on ``device``, or None without weights."""
    from playablevideogeneration_tpu_torch.evaluation.metrics import i3d

    path = find_weights(config, "i3d")
    if path is None:
        return None
    if logger is not None:
        logger.print(f"- Loading FVD I3D weights from {path}")
    return i3d.make_fvd_embedder(load_variables_npz(path), device)


def evaluation_backbones(config, logger=None, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The offline evaluation's backbones, found from the config, as keyword
    arguments of the dataset evaluators; the Inception Score's classifier
    only when ``evaluation.compute_inception_score`` is set."""
    vgg_variables, vgg_pretrained = get_vgg_variables(config, logger)
    inception_variables = _inception_variables(config, logger)
    want_is = bool(config.get("evaluation", {}).get("compute_inception_score", False))
    return dict(
        vgg_variables=vgg_variables if vgg_pretrained else None,
        lpips_fn=get_lpips_fn(config, logger, vgg_variables=vgg_variables,
                              vgg_pretrained=vgg_pretrained, device=device),
        fid_extractor=get_fid_extractor(config, logger, variables=inception_variables,
                                        device=device),
        fvd_embedder=get_fvd_embedder(config, logger, device=device),
        class_probability_fn=(get_class_probability_fn(
            config, logger, variables=inception_variables, device=device)
            if want_is else None),
    )
