"""Loads the JAX package's model variables into the port's modules.

The JAX variables are ``{"params", "batch_stats", "model_state"}`` trees of
nested dicts of arrays (numpy or anything ``np.asarray`` takes).  The port's
submodules carry the Flax names, so a leaf's path is its state key after
these renamings:

- the ``BatchNorm_0`` level that the JAX ``BatchNorm`` wrapper adds is dropped;
- conv ``kernel (kh, kw, in, out)`` -> ``weight (out, in, kh, kw)``, 3-D conv
  ``kernel (kd, kh, kw, in, out)`` -> ``weight (out, in, kd, kh, kw)``, dense
  ``kernel (in, out)`` -> ``weight (out, in)``;
- BN ``scale``/``bias`` -> ``weight``/``bias``, ``mean``/``var`` ->
  ``running_mean``/``running_var``;
- ConvLSTM ``initial_*_state (H, W, C)`` -> ``(C, H, W)``;
- ``model_state/centroids`` is copied as it is.

The same function loads the JAX VGG19 tree (``{"params": {"conv0": ...}}``)
into ``models.vgg.Vgg19``, and the converted metric backbones (FID
Inception, FVD I3D) into theirs.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from playablevideogeneration_tpu_torch.utils.device import DeviceLike, resolve_device

_COLLECTIONS = ("params", "batch_stats", "model_state")
_RENAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}
# A JAX kernel's axes in the order of the port's weight, by rank: conv
# (kh, kw, in, out), 3-D conv (kd, kh, kw, in, out), dense (in, out).
_KERNEL_AXES = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
# The port's state names back to the JAX leaves of a model without
# BatchNorm_0 levels, initial states or model state (the metric backbones).
_STATE_TO_JAX = {"running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var"),
                 "bias": ("params", "bias")}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (name,))
        else:
            yield prefix + (name,), np.asarray(value, dtype=np.float32)


def _convert(collection: str, path: Tuple[str, ...], value: np.ndarray
             ) -> Tuple[str, np.ndarray]:
    parts = [p for p in path if p != "BatchNorm_0"]
    leaf = parts[-1]
    if leaf.startswith("initial_"):
        value = value.transpose(2, 0, 1)
    elif collection != "model_state":
        if leaf not in _RENAMES:
            raise KeyError(f"unknown leaf {collection}/{'/'.join(path)}")
        if leaf == "kernel":
            value = value.transpose(_KERNEL_AXES[value.ndim])
        parts[-1] = _RENAMES[leaf]
    return ".".join(parts), value


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Copies the JAX variables into ``model`` (values are cast to each
    target's dtype and device) and returns it.

    Every leaf is consumed, and every parameter and buffer of ``model``
    must be filled: a missing, extra or mis-shaped leaf raises.
    """
    targets = dict(itertools.chain(model.named_parameters(), model.named_buffers()))
    unknown = set(variables) - set(_COLLECTIONS)
    if unknown:
        raise KeyError(f"unknown variable collections {sorted(unknown)}")
    filled = set()
    for collection in _COLLECTIONS:
        for path, value in _leaves(variables.get(collection, {})):
            key, value = _convert(collection, path, value)
            if key not in targets:
                raise KeyError(f"extra leaf {collection}/{'/'.join(path)}: the "
                               f"model has no {key}")
            target = targets[key]
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{collection}/{'/'.join(path)} has shape "
                                 f"{value.shape}, {key} expects {tuple(target.shape)}")
            target.copy_(torch.from_numpy(np.array(value)))
            filled.add(key)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"no JAX leaf for {missing}")
    return model


def build_from_jax_variables(factory: Callable[[], nn.Module], variables: Mapping,
                             device: DeviceLike = "cuda") -> nn.Module:
    """``factory()``'s module on ``device`` in evaluation mode, holding the
    JAX variables: built without initialising its weights, since
    ``load_jax_variables`` fills every one."""
    with torch.device("meta"):
        model = factory()
    model = model.to_empty(device=resolve_device(device))
    return load_jax_variables(model, variables).eval()


def seeded_jax_variables(model: nn.Module, seed: int) -> Dict:
    """A numpy tree in the JAX layout of ``model`` (a module without
    BatchNorm_0 levels, initial states or model state; it may live on the
    ``meta`` device), filled from ``seed``: kernels He-normal (variance
    2 / fan-in, which carries the input's variations through deep ReLU
    stacks), BatchNorm scales and variances in [0.8, 1.2], biases and
    means N(0, 0.05^2), so that the BatchNorms do real work while
    activations stay O(1)."""
    rng = np.random.default_rng(seed)
    tree: Dict = {}
    for key, tensor in itertools.chain(model.named_parameters(), model.named_buffers()):
        *path, leaf = key.split(".")
        shape = tuple(tensor.shape)
        if leaf == "weight" and len(shape) > 1:
            axes = _KERNEL_AXES[len(shape)]
            shape = tuple(shape[axes.index(i)] for i in range(len(shape)))
            collection, leaf = "params", "kernel"
            value = rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        else:
            collection, leaf = _STATE_TO_JAX.get(leaf, ("params", "scale"))
            value = (rng.uniform(0.8, 1.2, shape) if leaf in ("scale", "var")
                     else rng.normal(0.0, 0.05, shape))
        node = tree.setdefault(collection, {})
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value.astype(np.float32)
    return tree
