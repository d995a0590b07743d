"""The operation and byte counts against hand counts at a tiny shape."""
import math

import pytest
import torch

from pvg_bench import counts
from pvg_bench.reference import model as ref
from pvg_bench.reference import train as ref_train
from pvg_bench.tests.tiny import tiny_config


def _hand_flops(config, run):
    """2 operations per weight and output position of every convolution and
    dense layer, read from hooks: forward, and, for each call whose output
    receives a gradient in the backward, the input's gradient where the
    input takes one and the weight's where it does."""
    totals = {"forward": 0, "backward": 0}

    def hook(module, args, out):
        x = args[0]
        if isinstance(module, torch.nn.Conv2d):
            n, _, h, w = out.shape
            one = 2 * n * h * w * module.weight[0].numel() * module.weight.shape[0]
        else:
            one = 2 * math.prod(x.shape[:-1]) * module.weight.numel()
        totals["forward"] += one
        if out.requires_grad:
            backward = one * (int(x.requires_grad) + int(module.weight.requires_grad))
            out.register_hook(lambda grad: totals.__setitem__(
                "backward", totals["backward"] + backward))

    with torch.device("meta"):
        model, vgg = ref.Caddy(config), ref.Vgg19()
    handles = [m.register_forward_hook(hook) for mod in (model, vgg) for m in mod.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    run(model, vgg)
    for h in handles:
        h.remove()
    return totals


def test_play_flops_and_bytes():
    config = tiny_config("bair", bf16=True)
    got = counts.play_counts(config)

    def play(model, vgg):
        model.eval()
        with torch.no_grad():
            model.play_step(model.dynamics_network.init_carry(1),
                            torch.empty(1, 3, 32, 32, device="meta"),
                            torch.empty(1, 7, device="meta"), torch.empty(1, 2, device="meta"))
    assert got["flops"] == _hand_flops(config, play)["forward"]
    # Hidden 16 at 4 x 4, 32 at 2 x 2, 16 at 4 x 4; 15 frozen BatchNorm +
    # LeakyReLU pairs, the first 16 channels at 16 x 16.
    assert got["gate_shapes"] == [(1, 16, 4, 4), (1, 32, 2, 2), (1, 16, 4, 4)]
    assert counts.gate_forward_bytes(config, got["gate_shapes"]) == (256 + 128 + 256) * 7 * 2
    assert len(got["norm_shapes"]) == 15 and got["norm_shapes"][0] == (1, 16, 16, 16)
    assert counts.norm_bytes(config, [(1, 16, 16, 16)]) == 2 * 4096 * 2 + 16 * 16


def test_train_flops_and_bytes():
    config = tiny_config("bair", bf16=True)
    got = counts.train_counts(config, 2, 4, 25001)

    def step(model, vgg):
        model.train()
        total, _ = ref_train.loss(model, vgg, config, torch.empty(2, 4, 3, 32, 32, device="meta"),
                                  ref.zero_noise("meta"), ref_train.schedules(config, 25001),
                                  torch.empty(7, 7, device="meta"))
        torch.autograd.grad(total, list(model.parameters()), allow_unused=True)
    hand = _hand_flops(config, step)
    # The model's own products of N = B (T - 1) = 6 rows, K = 7 actions and
    # D = 2 dimensions: the centroids' estimate (no gradient), the
    # variations (and their gradient in the samples) and the mutual
    # information's joint (and its gradient in both factors).
    n, k, d = 6, 7, 2
    products = 2 * n * k * d + 2 * (2 * n * k * d) + 3 * (2 * k * n * k)
    assert got["flops"] == hand["forward"] + hand["backward"] + products
    # 3 ConvLSTMs on each of the T - 1 = 3 steps; K2 moves 12 elements per
    # state element to K1's 7.
    assert len(got["gate_shapes"]) == 9
    elements = 3 * (2 * 16 * 16 + 2 * 32 * 4 + 2 * 16 * 16)
    assert counts.gate_backward_bytes(config, got["gate_shapes"]) == elements * 12 * 2


@pytest.mark.parametrize("bf16, peak", [(True, 989e12), (False, 67e12)])
def test_peaks(bf16, peak):
    assert counts.peak_flops(tiny_config("bair", bf16)) == peak
