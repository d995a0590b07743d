"""Reference (PyTorch) CADDY checkpoint -> the JAX package's variables tree.

Counterpart of ``playablevideogeneration_tpu/utils/reference_checkpoint.py``:
the reference's released checkpoints (``latest.pth.tar``, ``{"model":
state_dict, ...}``) become the ``{"params", "batch_stats", "model_state"}``
tree with flax names, which ``utils.jax_weights.load_jax_variables`` loads
into the port's modules: one weight bridge for both sources.

Architecture correspondence (reference name -> flax path):

- ``representation_network.{conv1,bn1,residuals.N}`` ->
  ``representation_network/{conv1,bn1,resN}``
- ``action_network.K.{residuals.N,mean_fc,variance_fc,final_fc}`` ->
  ``action_network_K/{resN,*_fc}``
- ``dynamics_network.recurrent_layers_blocks.I.0`` -> ``dynamics_network/lstmI``
  (the four per-gate convolutions input/forget/output/cell_gate fuse into
  one 4C ``gates`` convolution, concatenated on the output channels in
  i,f,o,g order)
- ``dynamics_network.recurrent_layers_blocks.I.1`` -> ``dynamics_network/bnI``
- ``dynamics_network.non_recurrent_blocks.{0,1,2}`` ->
  ``dynamics_network/{same0,up0,same1}``
- ``rendering_network.upsample_blocks.{0.0,0.1,1.0,1.1,2}`` ->
  ``rendering_network/{up0,res0,up1,res1,up2}``
- ``rendering_network.final_blocks.N`` -> ``rendering_network/finalN``
- ``state_to_hidden_state_layer.0`` -> ``state_to_hidden``
- ``centroid_estimator.estimated_centroids`` -> ``model_state/centroids``
- ResidualBlock ``downsample.{0,2}`` -> ``shortcut_conv`` / ``shortcut_bn``

Leaf transforms: conv kernels OIHW -> HWIO; linear weights (out, in) ->
(in, out); BatchNorm weight/bias -> scale/bias params and running
statistics -> batch_stats mean/var; ConvLSTM initial states (C, H, W) ->
(H, W, C); ``num_batches_tracked`` is dropped.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np

_GATE_ORDER = ("input_gate", "forget_gate", "output_gate", "cell_gate")


def _put(tree: Dict, path, leaf) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = leaf


def _conv_kernel(value: np.ndarray) -> np.ndarray:
    return np.transpose(value, (2, 3, 1, 0))  # OIHW -> HWIO


def _bn_leaves(reference_leaf: str, value: np.ndarray, block_level: bool):
    """(collection, tail path, value) of a BatchNorm leaf; a block-level
    BatchNorm sits in a wrapper with an extra ``BatchNorm_0`` level."""
    names = {"weight": ("params", "scale"), "bias": ("params", "bias"),
             "running_mean": ("batch_stats", "mean"),
             "running_var": ("batch_stats", "var")}
    collection, leaf = names[reference_leaf]
    tail = ["BatchNorm_0", leaf] if block_level else [leaf]
    return collection, tail, value


def _residual_tail(parts, value):
    """The innards of a ResidualBlock or SameBlock; ``parts`` starts at the
    layer name (conv1, bn1, downsample, ...)."""
    layer, leaf = parts[0], parts[-1]
    if layer in ("conv1", "conv2"):
        return [("params", [layer, "kernel"], _conv_kernel(value))]
    if layer in ("bn1", "bn2"):
        collection, tail, v = _bn_leaves(leaf, value, block_level=True)
        return [(collection, [layer] + tail, v)]
    if layer == "downsample":
        if parts[1] == "0":  # 1x1 conv
            return [("params", ["shortcut_conv", "kernel"], _conv_kernel(value))]
        collection, tail, v = _bn_leaves(leaf, value, block_level=True)
        return [(collection, ["shortcut_bn"] + tail, v)]
    raise KeyError(f"Unexpected residual-block layer {parts}")


def _up_block_tail(parts, value):
    layer, leaf = parts[0], parts[-1]
    if layer == "conv":
        return [("params", ["conv", "kernel"], _conv_kernel(value))]
    if layer == "norm":
        collection, tail, v = _bn_leaves(leaf, value, block_level=True)
        return [(collection, ["norm"] + tail, v)]
    raise KeyError(f"Unexpected up-block layer {parts}")


def convert_reference_state_dict(state_dict) -> Dict:
    """A reference model state_dict ({name: array-like}) as the variables
    tree ``{"params", "batch_stats", "model_state"}``."""
    state = {k: np.asarray(v) for k, v in state_dict.items()
             if "num_batches_tracked" not in k}
    variables: Dict = {"params": {}, "batch_stats": {}, "model_state": {}}

    # The gate fusion needs the four gate convolutions together.
    gate_pattern = re.compile(
        r"^dynamics_network\.recurrent_layers_blocks\.(\d)\.0\.cell\."
        r"(input_gate|forget_gate|output_gate|cell_gate)\.(weight|bias)$")
    fused: Dict[Tuple[str, str], Dict[str, np.ndarray]] = {}
    for key in list(state):
        match = gate_pattern.match(key)
        if match:
            idx, gate, leaf = match.groups()
            fused.setdefault((idx, leaf), {})[gate] = state.pop(key)
    for (idx, leaf), gates in fused.items():
        if set(gates) != set(_GATE_ORDER):
            raise KeyError(f"Incomplete ConvLSTM gates for lstm{idx}: {set(gates)}")
        stacked = np.concatenate([gates[g] for g in _GATE_ORDER], axis=0)
        value = _conv_kernel(stacked) if leaf == "weight" else stacked
        _put(variables["params"],
             ["dynamics_network", f"lstm{idx}", "cell", "gates",
              "kernel" if leaf == "weight" else "bias"], value)

    for key, value in state.items():
        parts = key.split(".")
        net, leaf = parts[0], parts[-1]

        if key == "centroid_estimator.estimated_centroids":
            _put(variables["model_state"], ["centroids"], value)
            continue
        if net == "state_to_hidden_state_layer":
            _put(variables["params"],
                 ["state_to_hidden", "kernel" if leaf == "weight" else "bias"],
                 _conv_kernel(value) if leaf == "weight" else value)
            continue

        if net == "representation_network":
            if parts[1] == "conv1":
                _put(variables["params"], [net, "conv1", "kernel"], _conv_kernel(value))
            elif parts[1] == "bn1":
                collection, tail, v = _bn_leaves(leaf, value, block_level=True)
                _put(variables[collection], [net, "bn1"] + tail, v)
            elif parts[1] == "residuals":
                for collection, tail, v in _residual_tail(parts[3:], value):
                    _put(variables[collection], [net, f"res{parts[2]}"] + tail, v)
            else:
                raise KeyError(f"Unmapped reference key {key}")
            continue

        if net == "action_network":
            target = f"action_network_{parts[1]}"
            if parts[2] == "residuals":
                for collection, tail, v in _residual_tail(parts[4:], value):
                    _put(variables[collection], [target, f"res{parts[3]}"] + tail, v)
            elif parts[2] in ("mean_fc", "variance_fc", "final_fc"):
                v = value.T if leaf == "weight" else value  # (out, in) -> (in, out)
                _put(variables["params"],
                     [target, parts[2], "kernel" if leaf == "weight" else "bias"], v)
            else:
                raise KeyError(f"Unmapped reference key {key}")
            continue

        if net == "dynamics_network":
            if parts[1] == "recurrent_layers_blocks":
                idx, sub = parts[2], parts[3]
                if sub == "0":  # the ConvLSTM's learnable initial states
                    name = {"initial_hidden_state": "initial_hidden_state",
                            "initial_hidden_cell_state": "initial_cell_state"}[parts[4]]
                    _put(variables["params"], [net, f"lstm{idx}", name],
                         np.transpose(value, (1, 2, 0)))
                else:  # the BatchNorm after the LSTM, without a wrapper
                    collection, tail, v = _bn_leaves(leaf, value, block_level=False)
                    _put(variables[collection], [net, f"bn{idx}"] + tail, v)
            elif parts[1] == "non_recurrent_blocks":
                block = {"0": "same0", "1": "up0", "2": "same1"}[parts[2]]
                mapper = _up_block_tail if block == "up0" else _residual_tail
                for collection, tail, v in mapper(parts[3:], value):
                    _put(variables[collection], [net, block] + tail, v)
            else:
                raise KeyError(f"Unmapped reference key {key}")
            continue

        if net == "rendering_network":
            if parts[1] == "upsample_blocks":
                stage = parts[2]
                if stage == "2":  # a bare UpBlock
                    for collection, tail, v in _up_block_tail(parts[3:], value):
                        _put(variables[collection], [net, "up2"] + tail, v)
                elif parts[3] == "0":  # UpBlock
                    for collection, tail, v in _up_block_tail(parts[4:], value):
                        _put(variables[collection], [net, f"up{stage}"] + tail, v)
                else:  # ResidualBlock
                    for collection, tail, v in _residual_tail(parts[4:], value):
                        _put(variables[collection], [net, f"res{stage}"] + tail, v)
            elif parts[1] == "final_blocks":
                _put(variables["params"],
                     [net, f"final{parts[2]}", "conv", "kernel" if leaf == "weight" else "bias"],
                     _conv_kernel(value) if leaf == "weight" else value)
            else:
                raise KeyError(f"Unmapped reference key {key}")
            continue

        raise KeyError(f"Unmapped reference key {key}")

    return variables


def load_reference_checkpoint(path: str) -> Dict:
    """Reads a reference ``.pth.tar`` checkpoint to the CPU and converts its
    model weights; returns the variables tree."""
    import torch

    # weights_only: the reference's format is tensors and primitives, and
    # a downloaded file must not run pickled code.  The tensors stay on
    # the CPU; the caller's load places each one.
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = payload["model"] if isinstance(payload, dict) and "model" in payload else payload
    return convert_reference_state_dict({k: v.numpy() for k, v in state_dict.items()})
