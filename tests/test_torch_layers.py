"""Block-level parity of the port's models/layers.py with the JAX blocks.

Each Flax block is initialised, its variables are replaced by seeded numpy
values with BatchNorm statistics far from (0, 1), and the same values go
into the port's block through ``load_jax_variables``.  Both run in eval
mode, f32, on the CPU, on the same numpy input.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    nchw, nhwc, random_variables, single_threaded_torch)

from playablevideogeneration_tpu.models import layers as jl
from playablevideogeneration_tpu_torch.models import layers as tl
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables

TOL = dict(rtol=1e-5, atol=1e-5)


def _parity(jax_block, torch_block, x, *args, seed=0):
    """Runs both blocks on the NHWC numpy input ``x``; returns the outputs
    as NHWC numpy."""
    variables = jax_block.init(jax.random.PRNGKey(0), jnp.asarray(x), *args)
    variables = random_variables(variables, seed)
    want = jax_block.apply(variables, jnp.asarray(x), *args)
    load_jax_variables(torch_block, variables)
    with torch.no_grad():
        got = torch_block.eval()(nchw(x))
    return nhwc(got), np.asarray(want)


def _input(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("activation", ["leaky_relu", None])
def test_batch_norm(activation):
    got, want = _parity(
        jl.BatchNorm(use_running_average=True, activation=activation),
        tl.BatchNorm(5, activation=activation), _input((2, 4, 4, 5)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("in_planes,out_planes,down", [
    (8, 8, 1),     # identity shortcut
    (8, 12, 2),    # conv shortcut with downsampling
    (8, 9, 1),     # conv shortcut, channels only (the encoder's last block)
])
def test_residual_block(in_planes, out_planes, down):
    got, want = _parity(
        jl.ResidualBlock(out_planes, down, train=False),
        tl.ResidualBlock(in_planes, out_planes, down),
        _input((2, 8, 8, in_planes)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("down", [1, 2])
def test_same_block(down):
    got, want = _parity(
        jl.SameBlock(6, down, train=False),
        tl.SameBlock(5, 6, down), _input((1, 8, 8, 5)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("late", [False, True])
def test_up_block(late):
    got, want = _parity(
        jl.UpBlock(6, upscaling_mode="bilinear", late_upscaling=late, train=False),
        tl.UpBlock(7, 6, late_upscaling=late), _input((1, 6, 5, 7)))
    assert got.shape == (1, 12, 10, 6)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kernel,subpixel", [(3, 0), (7, 0), (7, 4)])
def test_final_block(kernel, subpixel):
    """(7, 4) is the flagship's 7x7 RGB head in the JAX package's strided
    subpixel form; the port's direct conv takes the same weights."""
    got, want = _parity(
        jl.FinalBlock(3, kernel, subpixel_factor=subpixel, subpixel_mode="strided"),
        tl.FinalBlock(4, 3, kernel), _input((1, 16, 16, 4)))
    np.testing.assert_allclose(got, want, **TOL)


def test_channelwise_concat():
    spatial = _input((2, 3, 4, 5))
    vectors = _input((2, 3), seed=2), _input((2, 2), seed=3)
    want = jl.channelwise_concat([jnp.asarray(spatial)] + list(map(jnp.asarray, vectors)))
    got = tl.channelwise_concat([nchw(spatial)] + list(map(torch.from_numpy, vectors)))
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))
    with pytest.raises(ValueError):
        tl.channelwise_concat([torch.from_numpy(v) for v in vectors])


def test_conv_lstm_two_steps():
    """Learnable initial states, the fused gate conv over cat([x, h]) in
    i, f, o, g order, and the gate update, over two recurrent steps."""
    b, h, w, cin, c = 2, 5, 4, 3, 6
    jax_lstm = jl.ConvLSTM(out_planes=c, height=h, width=w)
    xs = [_input((b, h, w, cin), seed=s) for s in (4, 5)]
    carry0 = (jnp.zeros((b, h, w, c)),) * 2
    variables = random_variables(
        jax_lstm.init(jax.random.PRNGKey(0), carry0, jnp.asarray(xs[0])), 6)
    torch_lstm = load_jax_variables(tl.ConvLSTM(cin, c, h, w), variables)

    jax_carry = jax_lstm.apply(variables, b, method="init_carry")
    with torch.no_grad():
        torch_carry = torch_lstm.init_carry(b)
        for want, got in zip(jax_carry, torch_carry):
            assert got.is_contiguous(memory_format=torch.channels_last)
            np.testing.assert_array_equal(nhwc(got), np.asarray(want))
        for x in xs:
            jax_carry, want = jax_lstm.apply(variables, jax_carry, jnp.asarray(x))
            torch_carry, got = torch_lstm(torch_carry, nchw(x))
            np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
            np.testing.assert_allclose(nhwc(torch_carry[1]), np.asarray(jax_carry[1]),
                                       **TOL)


@pytest.mark.parametrize("activation", ["leaky_relu", None])
def test_train_batch_norm_matches_flax_over_two_calls(activation):
    """Batch statistics in f32 as E[x^2] - E[x]^2; running statistics
    folded as flax folds them (keep 0.9, biased variance).  The input's
    mean is far from 0 so that torch's unbiased fold would show."""
    jax_bn = jl.BatchNorm(use_running_average=False, activation=activation)
    xs = [_input((2, 3, 3, 5), seed=s) * 2.0 + 1.5 for s in (7, 8)]
    variables = random_variables(jax_bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0])), 9)
    torch_bn = load_jax_variables(tl.BatchNorm(5, activation=activation), variables).train()
    for x in xs:
        want, mutated = jax_bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = dict(variables, **mutated)
        got = torch_bn(nchw(x))
        np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
        stats = variables["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(torch_bn.running_mean.numpy(), np.asarray(stats["mean"]),
                                   **TOL)
        np.testing.assert_allclose(torch_bn.running_var.numpy(), np.asarray(stats["var"]),
                                   **TOL)


def test_train_residual_block_matches_flax():
    """Every BatchNorm of a block in training mode, and the statistics the
    block's three BatchNorms fold."""
    jax_block = jl.ResidualBlock(6, 2, train=True)
    x = _input((2, 8, 8, 4))
    variables = random_variables(jax_block.init(jax.random.PRNGKey(0), jnp.asarray(x)), 10)
    want, mutated = jax_block.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    block = load_jax_variables(tl.ResidualBlock(4, 6, 2), variables).train()
    np.testing.assert_allclose(nhwc(block(nchw(x))), np.asarray(want), **TOL)
    fresh = load_jax_variables(tl.ResidualBlock(4, 6, 2), dict(variables, **mutated))
    for key, value in fresh.state_dict().items():
        torch.testing.assert_close(block.state_dict()[key], value, rtol=1e-5, atol=1e-6)


def test_frozen_statistics_normalises_with_the_batch_and_folds_nothing():
    block = tl.ResidualBlock(3, 4, 2).train()
    x = torch.randn(2, 3, 8, 8)
    before = {k: v.clone() for k, v in block.state_dict().items()}
    with tl.frozen_statistics(block):
        frozen = block(x)
    for key, value in block.state_dict().items():
        torch.testing.assert_close(value, before[key], rtol=0, atol=0)
    torch.testing.assert_close(block(x), frozen, rtol=0, atol=0)
    assert all(m.update_statistics for m in block.modules() if isinstance(m, tl.BatchNorm))
    assert not torch.equal(block.bn1.running_mean, before["bn1.running_mean"])


def test_parameters_stay_f32_and_casts_are_reused_without_gradients():
    """bf16 compute over f32 parameters: gradients are f32; with gradients
    off a cast is made once and remade only after the parameter changes."""
    conv = tl.Conv2d(3, 4, 3, True, torch.bfloat16)
    x = torch.randn(1, 3, 5, 5)
    conv(x).float().sum().backward()
    assert conv.weight.dtype == conv.weight.grad.dtype == torch.float32
    with torch.no_grad():
        first = conv(x)
        cast = conv._casts["weight"][1]
        conv(x)
        assert conv._casts["weight"][1] is cast
        conv.weight.add_(1.0)
        second = conv(x)
        assert conv._casts["weight"][1] is not cast
    assert first.dtype == torch.bfloat16 and not torch.equal(first, second)
