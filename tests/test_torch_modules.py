"""Parity of the port's training-route modules with the JAX package, on the
CPU: the action network, Gumbel sampling, the centroids, the bilinear
resize, VGG19, the weight bridge over the full model and VGG trees, and
``make_model``.  f32, rtol 1e-3 / atol 2e-4 unless a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    nchw, nhwc, random_variables, single_threaded_torch)

from playablevideogeneration_tpu.data.synthetic import make_synthetic_config
from playablevideogeneration_tpu.models import action as jax_action
from playablevideogeneration_tpu.models import centroids as jax_centroids
from playablevideogeneration_tpu.models import gumbel as jax_gumbel
from playablevideogeneration_tpu.models import vgg as jax_vgg
from playablevideogeneration_tpu.utils import tensor_ops as jax_tops
from playablevideogeneration_tpu_torch.models import action as port_action
from playablevideogeneration_tpu_torch.models import centroids
from playablevideogeneration_tpu_torch.models.caddy import Caddy, make_model
from playablevideogeneration_tpu_torch.models.gumbel import gumbel_noise, gumbel_softmax
from playablevideogeneration_tpu_torch.models.vgg import Vgg19, make_vgg
from playablevideogeneration_tpu_torch.utils import tensor_ops
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables

TOL = dict(rtol=1e-3, atol=2e-4)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def test_action_network_matches_jax(monkeypatch):
    """Train mode (batch statistics), the f32 heads, |variance|, the
    direction Gaussians and both reparameterised draws, fed the same
    numpy noise in call order."""
    draws = [_normal((6, 2), 1), _normal((2, 2, 2), 2)]
    calls = {"jax": 0, "port": 0}

    def noise(side, shape):
        value = draws[calls[side]]
        calls[side] += 1
        assert value.shape == tuple(shape)
        return value

    monkeypatch.setattr(jax_action, "reparameterized_sample", lambda key, m, v: (
        jnp.asarray(noise("jax", m.shape)) * jnp.sqrt(v) + m))
    monkeypatch.setattr(port_action, "reparameterized_sample", lambda gen, m, v: (
        torch.from_numpy(noise("port", m.shape)) * torch.sqrt(v) + m))
    states = _normal((2, 3, 4, 4, 8), 3)
    attention = np.random.default_rng(4).uniform(size=(2, 3, 4, 4, 1)).astype(np.float32)
    jax_net = jax_action.ActionNetwork(state_features=8, actions_count=3,
                                       action_space_dimension=2)
    variables = jax_net.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                             jnp.asarray(states), jnp.asarray(attention))
    calls["jax"] = 0
    variables = random_variables(variables, 5)
    want, mutated = jax_net.apply(variables, jnp.asarray(states), jnp.asarray(attention),
                                  mutable=["batch_stats"], rngs={"sample": jax.random.PRNGKey(2)})
    net = load_jax_variables(port_action.ActionNetwork(8, 3, 2), variables).train()
    seq = lambda x: torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 4, 2, 3)))  # noqa
    got = net(torch.Generator(), seq(states), seq(attention))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    fresh = load_jax_variables(port_action.ActionNetwork(8, 3, 2),
                               dict(variables, **mutated))
    for key, value in fresh.state_dict().items():
        torch.testing.assert_close(net.state_dict()[key], value, rtol=1e-5, atol=1e-6)


def test_action_heads_run_in_f32_under_bf16():
    net = port_action.ActionNetwork(8, 3, 2, dtype=torch.bfloat16).train()
    states = torch.randn(2, 3, 8, 4, 4, dtype=torch.bfloat16)
    logits, dirs, sampled_dirs, states_dist, sampled = net(
        torch.Generator().manual_seed(0), states, torch.ones(2, 3, 1, 4, 4, dtype=torch.bfloat16))
    assert states_dist.dtype == dirs.dtype == sampled_dirs.dtype == torch.float32
    assert logits.dtype == torch.bfloat16


def test_reparameterized_sample_draws_from_the_generator():
    mean, variance = torch.full((20000,), 2.0), torch.full((20000,), 0.25)
    samples = [port_action.reparameterized_sample(torch.Generator().manual_seed(s), mean,
                                                  variance) for s in (3, 3, 4)]
    torch.testing.assert_close(samples[0], samples[1], rtol=0, atol=0)
    assert not torch.equal(samples[0], samples[2])
    assert abs(samples[0].mean().item() - 2.0) < 0.02
    assert abs(samples[0].std().item() - 0.5) < 0.02


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_matches_jax(hard):
    """The same Gumbel noise (JAX's draw for the key) through both; the
    hard mode's straight-through gradient is the soft one."""
    key = jax.random.PRNGKey(7)
    log_probs = jax.nn.log_softmax(jnp.asarray(_normal((5, 4), 8)), axis=-1)
    weights = _normal((5, 4), 9)

    def jax_objective(lp):
        return jnp.sum(jax_gumbel.gumbel_softmax_sample(key, lp, 0.7, hard) * weights)

    want = jax_gumbel.gumbel_softmax_sample(key, log_probs, 0.7, hard)
    want_grad = jax.grad(jax_objective)(log_probs)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, log_probs.shape)))
    lp = torch.from_numpy(np.array(log_probs)).requires_grad_()
    got = gumbel_softmax(lp, noise, 0.7, hard)
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lp.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-6)
    if hard:
        assert set(np.unique(got.detach().numpy())) <= {0.0, 1.0}


def test_gumbel_noise_is_standard_gumbel():
    noise = gumbel_noise(torch.Generator().manual_seed(0), (200000,), torch.device("cpu"))
    assert abs(noise.mean().item() - np.euler_gamma) < 0.01
    assert abs(noise.var().item() - np.pi ** 2 / 6) < 0.03


def test_centroids_match_jax():
    points_priors = _normal((10, 2, 3), 1)
    assign = np.random.default_rng(2).dirichlet(np.ones(4), size=10).astype(np.float32)
    cents = _normal((4, 3), 3)
    want = jax_centroids.update_centroids(jnp.asarray(cents), jnp.asarray(points_priors),
                                          jnp.asarray(assign), 0.1)
    got = centroids.update_centroids(torch.from_numpy(cents), torch.from_numpy(points_priors),
                                     torch.from_numpy(assign), 0.1)
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    points = _normal((10, 3), 4)
    want = jax_centroids.compute_variations(jnp.asarray(points), jnp.asarray(assign),
                                            jnp.asarray(cents))
    got = centroids.compute_variations(torch.from_numpy(points), torch.from_numpy(assign),
                                       torch.from_numpy(cents))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # bf16 assignments promote against the f32 points, as in JAX.
    bf16 = centroids.compute_variations(torch.from_numpy(points),
                                        torch.from_numpy(assign).bfloat16(),
                                        torch.from_numpy(cents))
    assert bf16.dtype == torch.float32
    np.testing.assert_allclose(centroids.average_centroid_distance(torch.from_numpy(cents)),
                               jax_centroids.average_centroid_distance(jnp.asarray(cents)),
                               rtol=1e-6)


@pytest.mark.parametrize("size", [(16, 16), (8, 8), (16, 8), (64, 64)])
def test_resize_bilinear_matches_jax(size):
    """Shrinking antialiases as ``jax.image.resize`` does; plain bilinear
    interpolation would differ by far more than the tolerance."""
    x = _normal((2, 32, 32, 3), 5)
    want = np.asarray(jax_tops.resize_bilinear(jnp.asarray(x), *size))
    got = tensor_ops.resize_bilinear(nchw(x), *size)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-5)
    plain = F.interpolate(nchw(x), size=size, mode="bilinear", align_corners=False)
    assert (np.abs(nhwc(plain) - want).max() > 0.1) == (size[0] < 32)


def test_sequence_helpers_match_jax():
    x = _normal((2, 3, 4), 6)
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(tensor_ops.flatten(tx).numpy(), jax_tops.flatten(x))
    np.testing.assert_array_equal(tensor_ops.fold(tensor_ops.flatten(tx), 3).numpy(), x)
    with pytest.raises(ValueError):
        tensor_ops.fold(tx, 4)
    pred, succ = tensor_ops.predecessor_successor_split(tx)
    np.testing.assert_array_equal(pred.numpy(), x[:, :-1])
    np.testing.assert_array_equal(succ.numpy(), x[:, 1:])
    np.testing.assert_array_equal(tensor_ops.time_major(tx).numpy(), jax_tops.time_major(x))
    np.testing.assert_array_equal(
        tensor_ops.batch_major(tensor_ops.time_major(tx)).numpy(), x)


@pytest.fixture(scope="module")
def vgg_variables():
    return random_variables(jax.eval_shape(jax_vgg.random_vgg_variables,
                                           jax.random.PRNGKey(0)), 13)


def test_vgg_matches_jax_with_input_gradients(vgg_variables):
    """All five slices, the empty deepest map of a 16x16 input, and the
    gradient that flows to the input while the weights stay frozen."""
    x = _normal((2, 16, 16, 3), 14, 0.5)
    apply = jax_vgg.make_vgg_apply(vgg_variables)
    want = apply(jnp.asarray(x))
    want_grad = jax.grad(lambda v: sum(jnp.sum(f ** 2) for f in apply(v)))(jnp.asarray(x))
    vgg = load_jax_variables(Vgg19(), vgg_variables)
    xt = nchw(x).requires_grad_()
    got = vgg(xt)
    assert [tuple(nhwc(g).shape) for g in got] == [w.shape for w in want]
    assert got[-1].shape[2:] == (1, 1)
    sum(g.square().sum() for g in got).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(want_grad), rtol=1e-3,
                               atol=1e-4 * np.abs(want_grad).max())
    assert all(p.grad is None and not p.requires_grad for p in vgg.parameters())
    empty = vgg(torch.zeros(1, 3, 8, 8))
    assert empty[-1].shape == (1, 512, 0, 0)


def test_full_jax_trees_load_with_no_leaf_left_over(tiny_model, tiny_variables, vgg_variables):
    """The whole model tree, action networks and ``state_to_hidden``
    included, and the VGG tree: every leaf lands, every parameter and
    buffer is filled (the loader raises otherwise)."""
    variables = random_variables(tiny_variables, 15)
    assert {"action_network_0", "state_to_hidden"} <= set(variables["params"])
    model = load_jax_variables(Caddy(3, 2, 8, (4, 4), 8, 2), variables)
    np.testing.assert_array_equal(
        model.action_network_0.final_fc.weight.detach().numpy(),
        variables["params"]["action_network_0"]["final_fc"]["kernel"].T)
    np.testing.assert_array_equal(
        model.state_to_hidden.weight.detach().numpy(),
        variables["params"]["state_to_hidden"]["kernel"].transpose(3, 2, 0, 1))
    leaves = sum(1 for _ in jax.tree_util.tree_leaves(variables))
    assert leaves == len(model.state_dict())
    vgg = load_jax_variables(Vgg19(), vgg_variables)
    assert len(jax.tree_util.tree_leaves(vgg_variables)) == len(vgg.state_dict()) == 26
    with pytest.raises(KeyError, match="conv12"):
        load_jax_variables(Vgg19(), {"params": {k: v for k, v in vgg_variables["params"].items()
                                                if k != "conv12"}})


def test_make_model_reads_the_training_keys():
    config = make_synthetic_config(data_root="/nonexistent", output_root="/nonexistent",
                                   height=32, width=32, actions_count=3, state_features=8,
                                   hidden_state_size=8)
    action = config["model"]["action_network"]
    action.update(use_gumbel=False, hard_gumbel=True, ensamble_size=2, use_variations=False)
    config["model"]["centroid_estimator"]["alpha"] = 0.3
    config["training"]["pretraining_detach"] = True
    config["tpu"] = {"remat": True, "compute_dtype": "bfloat16"}
    model = make_model(config, device="cpu")
    assert (model.use_gumbel, model.hard_gumbel, model.ensemble_size, model.use_variations,
            model.centroid_alpha, model.pretraining_detach, model.checkpoint_steps,
            model.dtype) == (False, True, 2, False, 0.3, True, True, torch.bfloat16)
    assert model.action_networks(1) is model.action_network_1
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert not model.training
    with pytest.raises(NotImplementedError):
        model.forward_full_model(torch.zeros(1, 2, 6, 32, 32), torch.zeros(1, 2), 1,
                                 generator=torch.Generator())
    assert make_vgg("cpu", torch.bfloat16).conv0.compute_dtype == torch.bfloat16
