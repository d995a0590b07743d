"""Operations and bytes of a step, counted on the reference, and the peaks.

The floating-point operations of a step are counted once per shape by
``torch.utils.flop_counter.FlopCounterMode`` over the reference run on
meta tensors: the convolutions and matrix products of the forward, of the
VGG19 perceptual loss and of the backward (the configs recompute nothing).
The bytes of the port's kernels are counted at the model's own shapes,
each input read once and each output written once, whatever implements
the work: per state element K1 reads 4 gates and c and writes h' and c',
K2 reads the gates, c, dh and dc and writes the 4 gate gradients and
dc_prev; per element K3 reads x and writes y, plus 16 bytes per channel
of statistics.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from pvg_bench.reference import model as ref
from pvg_bench.reference import train as ref_train

# Published H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

K1_ELEMENTS_MOVED = 7  # gates (4C), c in; h', c' out
K2_ELEMENTS_MOVED = 12  # gates (4C), c, dh, dc in; dgates (4C), dc_prev out
K3_STATISTICS_BYTES = 16  # scale, bias, mean, var per channel, f32


def compute_bytes(config: dict) -> int:
    """Bytes per element of the configuration's compute dtype."""
    return 2 if config.get("tpu", {}).get("compute_dtype") == "bfloat16" else 4


def peak_flops(config: dict) -> float:
    return PEAK_BF16_FLOPS if compute_bytes(config) == 2 else PEAK_F32_FLOPS


class _Shapes:
    """Records, while the reference runs, the state shape of every ConvLSTM
    gate update and the input shape of every evaluation-mode BatchNorm
    followed by LeakyReLU."""

    def __init__(self, model: torch.nn.Module):
        self.gates: List[tuple] = []
        self.norms: List[tuple] = []
        self._handles = []
        for module in model.modules():
            if isinstance(module, ref.ConvLSTMCell):
                self._handles.append(module.register_forward_hook(
                    lambda m, args, out: self.gates.append(tuple(out[0][1].shape))))
            elif isinstance(module, ref.BatchNorm) and module.activation == "leaky_relu":
                self._handles.append(module.register_forward_hook(
                    lambda m, args, out: None if m.training
                    else self.norms.append(tuple(args[0].shape))))

    def close(self):
        for h in self._handles:
            h.remove()


def _meta_models(config: dict, vgg: bool):
    with torch.device("meta"):
        model = ref.Caddy(config)
        return (model, ref.Vgg19()) if vgg else (model, None)


def play_counts(config: dict) -> Dict[str, object]:
    """One play step at batch 1: its operations, and the K1 and K3 shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    model, _ = _meta_models(config, vgg=False)
    model.eval()
    height, width = (config["model"]["representation_network"]["target_input_size"][::-1])
    stacking = config["training"]["batching"]["observation_stacking"]
    window = torch.empty(1, 3 * stacking, height, width, device="meta")
    onehot = torch.empty(1, model.actions_count, device="meta")
    variation = torch.empty(1, model.action_space_dimension, device="meta")
    shapes = _Shapes(model)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.play_step(model.dynamics_network.init_carry(1), window, onehot, variation)
    shapes.close()
    return dict(flops=counter.get_total_flops(), gate_shapes=shapes.gates,
                norm_shapes=shapes.norms)


def train_counts(config: dict, batch_size: int, frames: int, step: int) -> Dict[str, object]:
    """One training step at global step ``step`` on a (batch_size, frames)
    batch: its operations (forward, perceptual loss, backward), and the K1
    and K2 shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    model, vgg = _meta_models(config, vgg=True)
    model.train()
    height, width = (config["model"]["representation_network"]["target_input_size"][::-1])
    stacking = config["training"]["batching"]["observation_stacking"]
    observations = torch.empty(batch_size, frames, 3 * stacking, height, width, device="meta")
    schedule = ref_train.schedules(config, step)
    mi = (torch.empty(model.actions_count, model.actions_count, device="meta")
          if config["training"]["trainer"].endswith("smooth_mi_trainer") else None)
    shapes = _Shapes(model)
    params = list(model.parameters())
    with FlopCounterMode(display=False) as counter:
        total, _ = ref_train.loss(model, vgg, config, observations, ref.zero_noise("meta"),
                                  schedule, mi)
        torch.autograd.grad(total, params, allow_unused=True)
    shapes.close()
    return dict(flops=counter.get_total_flops(), gate_shapes=shapes.gates)


def gate_forward_bytes(config: dict, shapes) -> int:
    return sum(math.prod(s) for s in shapes) * K1_ELEMENTS_MOVED * compute_bytes(config)


def gate_backward_bytes(config: dict, shapes) -> int:
    return sum(math.prod(s) for s in shapes) * K2_ELEMENTS_MOVED * compute_bytes(config)


def norm_bytes(config: dict, shapes) -> int:
    return sum(2 * math.prod(s) * compute_bytes(config) + K3_STATISTICS_BYTES * s[1]
               for s in shapes)
