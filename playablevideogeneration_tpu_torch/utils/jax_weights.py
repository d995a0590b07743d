"""Loads the JAX package's model variables into the port's modules.

The JAX variables are ``{"params", "batch_stats", "model_state"}`` trees of
nested dicts of arrays (numpy or anything ``np.asarray`` takes).  The port's
submodules carry the Flax names, so a leaf's path is its state key after
these renamings:

- the ``BatchNorm_0`` level that the JAX ``BatchNorm`` wrapper adds is dropped;
- conv ``kernel (kh, kw, in, out)`` -> ``weight (out, in, kh, kw)``, dense
  ``kernel (in, out)`` -> ``weight (out, in)``;
- BN ``scale``/``bias`` -> ``weight``/``bias``, ``mean``/``var`` ->
  ``running_mean``/``running_var``;
- ConvLSTM ``initial_*_state (H, W, C)`` -> ``(C, H, W)``;
- ``model_state/centroids`` is copied as it is.

The same function loads the JAX VGG19 tree (``{"params": {"conv0": ...}}``)
into ``models.vgg.Vgg19``.
"""
from __future__ import annotations

import itertools
from typing import Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_COLLECTIONS = ("params", "batch_stats", "model_state")
_RENAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}


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
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
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
