"""Parity of the port's training/losses.py and training/schedules.py with
the JAX package, on the CPU: each loss function's value and input
gradient on the same numpy inputs (f32, rtol 1e-4 / atol 1e-6 unless a
test says otherwise), the schedules, and one Adam step with its
learning-rate milestone against optax.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    random_variables, single_threaded_torch)

from playablevideogeneration_tpu.models import vgg as jax_vgg
from playablevideogeneration_tpu.training import losses as jax_losses
from playablevideogeneration_tpu.training import schedules as jax_schedules
from playablevideogeneration_tpu_torch.models.vgg import Vgg19
from playablevideogeneration_tpu_torch.training import losses, schedules
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables

TOL = dict(rtol=1e-4, atol=1e-6)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _probabilities(shape, seed):
    return np.random.default_rng(seed).dirichlet(np.ones(shape[-1]),
                                                 size=shape[:-1]).astype(np.float32)


def _sequence_nchw(x):
    """(B, T, H, W, C) numpy -> (B, T, C, H, W)."""
    return np.ascontiguousarray(x.transpose(0, 1, 4, 2, 3)) if x.ndim == 5 else x


def _distribution(shape, seed):
    """(..., 2, D) (mean, variance) pairs with positive variances."""
    x = _normal(shape, seed)
    x[..., 1, :] = np.abs(x[..., 1, :]) + 0.01
    return x


def _check(jax_fn, port_fn, inputs, grad_arg=0, tol=TOL):
    """Value and the gradient of the value w.r.t. ``inputs[grad_arg]``;
    ``inputs`` are JAX-layout numpy arrays (sequences NHWC)."""
    want, want_grad = jax.value_and_grad(
        lambda *a: jax_fn(*a)[0] if isinstance(jax_fn(*a), tuple) else jax_fn(*a),
        argnums=grad_arg)(*map(jnp.asarray, inputs))
    tensors = [torch.from_numpy(_sequence_nchw(x)) for x in inputs]
    tensors[grad_arg].requires_grad_()
    got = port_fn(*tensors)
    got = got[0] if isinstance(got, tuple) else got
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **tol)
    np.testing.assert_allclose(tensors[grad_arg].grad.numpy(),
                               _sequence_nchw(np.asarray(want_grad)), **tol)


OBS = _normal((2, 4, 16, 16, 6), 1, 0.5)
REC_T = _normal((2, 4, 8, 8, 3), 2, 0.5)
REC_T1 = _normal((2, 3, 16, 16, 3), 3, 0.5)
MASK = np.abs(_normal((2, 4, 16, 16, 1), 4)) + 0.1


@pytest.mark.parametrize("case", ["same_length", "shorter_resized", "masked", "masked_shorter"])
def test_observations_loss(case):
    rec = {"same_length": REC_T, "shorter_resized": REC_T1, "masked": REC_T,
           "masked_shorter": REC_T1}[case]
    if case.startswith("masked"):
        _check(jax_losses.observations_loss, losses.observations_loss, [OBS, rec, MASK],
               grad_arg=1)
    else:
        _check(jax_losses.observations_loss, losses.observations_loss, [OBS, rec], grad_arg=1)


@pytest.mark.parametrize("name", ["states_loss", "hidden_states_loss"])
def test_mse_losses(name):
    a = _normal((2, 3, 4, 4, 5), 5)
    b = _normal((2, 4 if name == "hidden_states_loss" else 3, 4, 4, 5), 6)
    _check(getattr(jax_losses, name), getattr(losses, name), [a, b], grad_arg=0)


def test_kl_losses():
    logits_a, logits_b = _normal((2, 3, 4), 7), _normal((2, 3, 4), 8)
    _check(jax_losses.kl_divergence_categorical, losses.kl_divergence_categorical,
           [logits_a, logits_b])
    dist = _distribution((2, 3, 2, 2), 9)
    _check(jax_losses.kl_gaussian_divergence, losses.kl_gaussian_divergence, [dist])
    ref = _distribution((2, 3, 2, 2), 10)
    ref[0, 0, 1, 0] = 0.01  # under the eps clamp
    _check(jax_losses.kl_general_gaussian_divergence, losses.kl_general_gaussian_divergence,
           [dist, ref])
    _check(jax_losses.kl_general_gaussian_divergence, losses.kl_general_gaussian_divergence,
           [dist, ref], grad_arg=1)


def test_kl_variance_floor_keeps_a_zero_variance_finite():
    dist = _distribution((4, 2, 2), 11)
    dist[0, 1, 0] = 0.0
    tensor = torch.from_numpy(dist).requires_grad_()
    for fn in (losses.kl_gaussian_divergence,
               lambda d: losses.kl_general_gaussian_divergence(d, d.detach() + 0.1)):
        value = fn(tensor)
        value.backward()
        assert torch.isfinite(value) and torch.isfinite(tensor.grad).all()
        np.testing.assert_allclose(
            value.item(), float((jax_losses.kl_gaussian_divergence(jnp.asarray(dist))
                                 if fn is losses.kl_gaussian_divergence else
                                 jax_losses.kl_general_gaussian_divergence(
                                     jnp.asarray(dist), jnp.asarray(dist) + 0.1))), **TOL)
        tensor.grad = None


def test_general_kl_detaches_both_variances():
    dist = torch.from_numpy(_distribution((3, 2, 2), 12)).requires_grad_()
    ref = torch.from_numpy(_distribution((3, 2, 2), 13)).requires_grad_()
    losses.kl_general_gaussian_divergence(dist, ref).backward()
    assert (dist.grad[:, 1] == 0).all() and (ref.grad[:, 1] == 0).all()
    assert (dist.grad[:, 0] != 0).any() and (ref.grad[:, 0] != 0).any()


def test_entropies():
    _check(jax_losses.entropy_logits, losses.entropy_logits, [_normal((2, 3, 4), 14)])
    _check(jax_losses.entropy_probabilities, losses.entropy_probabilities,
           [_probabilities((2, 3, 4), 15)])
    one_hot = torch.eye(4)[torch.tensor([0, 2, 3])]
    assert losses.entropy_probabilities(one_hot).item() == 0.0


@pytest.mark.parametrize("lamb", [1.0, 1.3])
def test_mutual_information(lamb):
    p1, p2 = _probabilities((2, 3, 4), 16), _probabilities((2, 3, 4), 17)
    np.testing.assert_allclose(
        losses.joint_probability_matrix(torch.from_numpy(p1), torch.from_numpy(p2)).numpy(),
        np.asarray(jax_losses.joint_probability_matrix(jnp.asarray(p1), jnp.asarray(p2))),
        **TOL)
    _check(lambda a, b: jax_losses.mutual_information_loss(a, b, lamb),
           lambda a, b: losses.mutual_information_loss(a, b, lamb), [p1, p2])
    matrix = _probabilities((16,), 18).reshape(4, 4)
    _check(lambda a, b: jax_losses.smooth_mutual_information_loss(a, b, matrix, 0.2, lamb),
           lambda a, b: losses.smooth_mutual_information_loss(a, b, torch.from_numpy(matrix),
                                                             0.2, lamb), [p1, p2])
    _, want = jax_losses.smooth_mutual_information_loss(jnp.asarray(p1), jnp.asarray(p2),
                                                        jnp.asarray(matrix), 0.2, lamb)
    _, got = losses.smooth_mutual_information_loss(
        torch.from_numpy(p1).requires_grad_(), torch.from_numpy(p2), torch.from_numpy(matrix),
        0.2, lamb)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(losses.init_mi_matrix(4).numpy(),
                                  np.asarray(jax_losses.init_mi_matrix(4)))


def test_motion_weight_mask():
    for rec in (REC_T1, _normal((2, 4, 16, 16, 3), 19)):
        want = jax_losses.motion_weight_mask(jnp.asarray(OBS), jnp.asarray(rec), 0.3)
        got = losses.motion_weight_mask(torch.from_numpy(_sequence_nchw(OBS)),
                                        torch.from_numpy(_sequence_nchw(rec)), 0.3)
        np.testing.assert_allclose(got.numpy(), _sequence_nchw(np.asarray(want)), **TOL)


@pytest.fixture(scope="module")
def vgg_pair():
    variables = random_variables(jax.eval_shape(jax_vgg.random_vgg_variables,
                                                jax.random.PRNGKey(0)), 20)
    return jax_vgg.make_vgg_apply(variables), load_jax_variables(Vgg19(), variables)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rec", ["shorter", "resized"])
def test_perceptual_loss(vgg_pair, masked, rec):
    """Five levels (the deepest one empty for the 8x8 frames), the ground truth
    resized and detached, with and without the motion mask.  The VGG's
    backward sums 13 convolutions in framework order: rtol 1e-3."""
    jax_vgg_apply, vgg = vgg_pair
    rec_name, rec = rec, REC_T1 if rec == "shorter" else REC_T
    inputs = [OBS, rec] + ([MASK] if masked else [])

    def levels(fn, *args):
        return fn(*args)[1]

    _check(lambda *a: jax_losses.perceptual_loss(jax_vgg_apply, *a),
           lambda *a: losses.perceptual_loss(vgg, *a), inputs, grad_arg=1,
           tol=dict(rtol=1e-3, atol=1e-5))
    want = levels(jax_losses.perceptual_loss, jax_vgg_apply, *map(jnp.asarray, inputs))
    got = levels(losses.perceptual_loss, vgg,
                 *[torch.from_numpy(_sequence_nchw(x)) for x in inputs])
    assert len(got) == 5 and (got[-1].item() == 0.0) == (rec_name == "resized")
    np.testing.assert_allclose([g.item() for g in got], np.asarray(want), rtol=1e-3)


def test_schedules_match_jax():
    for step in range(0, 40, 3):
        assert (schedules.ground_truth_observations_count(step, 6, 2, 17)
                == jax_schedules.ground_truth_observations_count(step, 6, 2, 17))
        assert (schedules.gumbel_temperature(step, 1.0, 0.4, 23)
                == jax_schedules.gumbel_temperature(step, 1.0, 0.4, 23))
        assert (schedules.observations_count(step, 7, 12, 25)
                == jax_schedules.observations_count(step, 7, 12, 25))


def test_adam_steps_and_milestone_match_optax():
    """Five updates through the milestone at update 3: torch's Adam with
    weight decay and MultiStepLR against the JAX package's optax chain."""
    config = {"training": {"learning_rate": 0.01, "weight_decay": 0.05,
                           "lr_schedule": [3, 10000000000], "lr_gamma": 0.25}}
    params = {"w": _normal((3, 4), 21), "b": _normal((4,), 22)}
    grads = [{k: _normal(v.shape, 30 + 2 * i + j) for j, (k, v) in enumerate(params.items())}
             for i in range(5)]
    tx, lr_schedule = jax_schedules.make_optimizer(config)
    jax_params, opt_state = jax.tree.map(jnp.asarray, params), None
    opt_state = tx.init(jax_params)
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    optimizer, scheduler = schedules.make_optimizer(config, tensors.values())
    for i, g in enumerate(grads):
        assert scheduler.get_last_lr()[0] == pytest.approx(float(lr_schedule(i)))
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for k, p in tensors.items():
            p.grad = torch.from_numpy(g[k])
        optimizer.step()
        scheduler.step()
        for k, p in tensors.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jax_params[k]),
                                       rtol=1e-5, atol=1e-6)
    assert scheduler.get_last_lr()[0] == pytest.approx(0.0025)
