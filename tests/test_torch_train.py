"""Parity of the port's training route with the JAX package, on the CPU.

The conftest tiny model (3 actions, 8 features, state 4x4, stacking 2,
32x32 frames) gets the same seeded numpy weights in both packages, the same
numpy batch and the same noise: the action networks' reparameterised
samples and the Gumbel noise are patched, in both packages, to draw from
one numpy source in call order.  Each JAX program is traced once (module
fixtures); its noise is then fixed, so the port draws the same numbers at
every step.

Tolerances: forwards and losses rtol 1e-3 / atol 2e-4 (f32, as the play
route); gradients rtol 2e-3 with atol 1e-4 of each leaf's largest
magnitude in the full phase, since the two frameworks sum the
convolutions' backward in different orders.  The pretraining gradients
take atol 3e-3 of the leaf's largest magnitude: train-mode BatchNorm's
variance E[x^2] - E[x]^2 in f32 cancels and amplifies the frameworks'
rounding (forward outputs differ by up to 2e-5 relative), and this phase's
gradients are that ill-conditioned: perturbing the weights by 1e-6
relative moves the port's own pretraining gradients by 1.3e-3 of a leaf's
largest magnitude, and the two frameworks differ by up to 1e-3.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    NOISE, patched_noise, random_variables, single_threaded_torch, to_port_layout)

from playablevideogeneration_tpu.config.configuration import Configuration
from playablevideogeneration_tpu.data.synthetic import make_synthetic_config
from playablevideogeneration_tpu.models import vgg as jax_vgg
from playablevideogeneration_tpu.training import losses as jax_losses
from playablevideogeneration_tpu.training import trainer as jax_trainer
from playablevideogeneration_tpu.training.bench_harness import NullDataset
from playablevideogeneration_tpu.training.train_state import TrainState as JaxTrainState
from playablevideogeneration_tpu.utils.logging import Logger
from playablevideogeneration_tpu_torch.data.transforms import get_final_transforms
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset
from playablevideogeneration_tpu_torch.models.caddy import Caddy
from playablevideogeneration_tpu_torch.models.vgg import Vgg19
from playablevideogeneration_tpu_torch.training import losses
from playablevideogeneration_tpu_torch.training.trainer import Trainer, compute_loss_terms
from playablevideogeneration_tpu_torch.utils.jax_weights import (
    _convert,
    _leaves,
    load_jax_variables,
)

TOL = dict(rtol=1e-3, atol=2e-4)
B, T, GT_INIT, GUMBEL_T = 2, 4, 2, 0.8
# Every term weighted, so every term's gradient is checked.
LOSS_WEIGHTS = {}
for _name, _value in [("reconstruction_loss_lambda", 1.0), ("perceptual_loss_lambda", 1.0),
                      ("states_rec_lambda", 0.2), ("entropy_lambda", 0.1),
                      ("action_directions_kl_lambda", 0.01),
                      ("action_mutual_information_lambda", 0.15),
                      ("action_state_distribution_kl_lambda", 0.1)]:
    LOSS_WEIGHTS[_name] = LOSS_WEIGHTS[_name + "_pretraining"] = _value
LOSS_WEIGHTS["hidden_states_rec_lambda_pretraining"] = 1.0
MI_ALPHA = 0.2
# Gradients' atol as a share of each leaf's largest magnitude, by phase
# (pretraining: see the module docstring).
GRAD_ATOL = {False: 1e-4, True: 3e-3}
@pytest.fixture(scope="module", autouse=True)
def shared_noise():
    with patched_noise():
        yield


@pytest.fixture(scope="module")
def weights(tiny_variables):
    """Seeded numpy model and VGG variables (shapes from the JAX inits)."""
    vgg_shapes = jax.eval_shape(jax_vgg.random_vgg_variables, jax.random.PRNGKey(0))
    return random_variables(tiny_variables, seed=11), random_variables(vgg_shapes, seed=12)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    return (rng.uniform(-1, 1, (B, T, 32, 32, 6)).astype(np.float32),
            rng.integers(0, 3, (B, T)).astype(np.int32))


def _port_model(tiny_model, variables, checkpoint_steps):
    model = Caddy(tiny_model.actions_count, tiny_model.action_space_dimension,
                  tiny_model.state_features, tiny_model.state_resolution,
                  tiny_model.hidden_state_size, tiny_model.observation_stacking,
                  checkpoint_steps=checkpoint_steps)
    return load_jax_variables(model, variables).train()


def _port_vgg(vgg_variables):
    return load_jax_variables(Vgg19(), vgg_variables)


def _nchw_sequence(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 1, 4, 2, 3)))


class _Capture:
    """Stands in for the JAX model inside ``compute_loss_terms`` and keeps
    the forward's ``ModelOutput`` for the comparison."""

    def __init__(self, model):
        self.model = model
        self.out = None

    def apply(self, *args, **kwargs):
        out, mutated = self.model.apply(*args, **kwargs)
        self.out = out
        return out, mutated


@pytest.fixture(scope="module")
def jax_runs(tiny_model, weights, batch):
    """Per phase: JAX forward outputs, loss terms, mutated statistics and
    parameter gradients of ``compute_loss_terms`` under
    ``jax.value_and_grad``, one program each."""
    variables, vgg_variables = weights
    obs, acts = map(jnp.asarray, batch)
    runs = {}
    for pretraining in (False, True):
        capture = _Capture(tiny_model)

        def loss_fn(params, rest, vgg_vars):
            total, aux = jax_trainer.compute_loss_terms(
                capture, dict(rest, params=params), obs, acts, GT_INIT, GUMBEL_T,
                jax.random.PRNGKey(0), jax_vgg.make_vgg_apply(vgg_vars), LOSS_WEIGHTS, 1.0,
                pretraining, False, 0.0, jax_losses.init_mi_matrix(3), MI_ALPHA)
            return total, (aux, capture.out)

        NOISE.reset()
        rest = {k: v for k, v in variables.items() if k != "params"}
        (total, (aux, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], rest, vgg_variables)
        runs[pretraining] = jax.device_get(dict(total=total, aux=aux, out=out, grads=grads))
    return runs


@pytest.fixture(scope="module")
def port_runs(tiny_model, weights, batch):
    """The port's counterparts of ``jax_runs``, per (phase, checkpointing)."""
    variables, vgg_variables = weights
    vgg = _port_vgg(vgg_variables)
    obs, acts = _nchw_sequence(batch[0]), torch.from_numpy(batch[1])
    runs = {}
    for pretraining in (False, True):
        for checkpoint_steps in (False, True):
            model = _port_model(tiny_model, variables, checkpoint_steps)
            captured = {}
            forward = model.forward

            def capture(*args, **kwargs):
                captured["out"] = forward(*args, **kwargs)
                return captured["out"]

            model.forward = capture
            NOISE.reset()
            total, aux = compute_loss_terms(
                model, obs, acts, GT_INIT, GUMBEL_T, torch.Generator(), vgg, LOSS_WEIGHTS,
                1.0, pretraining, False, 0.0, losses.init_mi_matrix(3), MI_ALPHA)
            total.backward()
            runs[pretraining, checkpoint_steps] = dict(
                total=total.item(), aux=aux, out=captured["out"], model=model)
    return runs


PHASES = [pytest.param(False, id="full"), pytest.param(True, id="pretraining")]


@pytest.mark.parametrize("pretraining", PHASES)
def test_forward_outputs_match_jax(jax_runs, port_runs, pretraining):
    want = jax_runs[pretraining]["out"]
    got = port_runs[pretraining, False]["out"]
    for name, value in vars(got).items():
        expected = getattr(want, name)
        if value is None:
            assert expected is None, name
            continue
        values, expecteds = ((value, expected) if isinstance(value, list)
                             else ([value], [expected]))
        assert len(values) == len(expecteds), name
        for v, e in zip(values, expecteds):
            np.testing.assert_allclose(v.detach().numpy(), to_port_layout(name, e),
                                       err_msg=name, **TOL)


@pytest.mark.parametrize("pretraining", PHASES)
def test_loss_terms_match_jax(jax_runs, port_runs, pretraining):
    want, got = jax_runs[pretraining], port_runs[pretraining, False]
    np.testing.assert_allclose(got["total"], want["total"], **TOL)
    info = want["aux"]["info"]
    assert sorted(got["aux"]["info"]) == sorted(info)
    for name, value in got["aux"]["info"].items():
        np.testing.assert_allclose(value.numpy(), info[name], err_msg=name, **TOL)
    np.testing.assert_allclose(got["aux"]["new_mi_matrix"].numpy(),
                               want["aux"]["new_mi_matrix"], **TOL)


def _assert_state_matches(model, mutated, collections=("batch_stats", "model_state")):
    buffers = dict(model.named_buffers())
    for collection in collections:
        for path, value in _leaves(mutated[collection]):
            key, value = _convert(collection, path, value)
            np.testing.assert_allclose(buffers[key].numpy(), value, err_msg=key, **TOL)


@pytest.mark.parametrize("checkpoint_steps", [False, True], ids=["plain", "checkpointed"])
@pytest.mark.parametrize("pretraining", PHASES)
def test_parameter_gradients_match_jax(jax_runs, port_runs, pretraining, checkpoint_steps):
    """Every parameter's gradient, and the BatchNorm statistics and
    centroids after the forward: checkpointing reruns each step's forward
    in the backward pass and must fold the statistics only once."""
    model = port_runs[pretraining, checkpoint_steps]["model"]
    params = dict(model.named_parameters())
    seen = set()
    for path, value in _leaves(jax_runs[pretraining]["grads"]):
        key, value = _convert("params", path, value)
        grad = params[key].grad
        grad = torch.zeros_like(params[key]) if grad is None else grad
        np.testing.assert_allclose(grad.numpy(), value, rtol=2e-3,
                                   atol=GRAD_ATOL[pretraining] * np.abs(value).max(),
                                   err_msg=key)
        seen.add(key)
    assert seen == set(params)
    _assert_state_matches(model, jax_runs[pretraining]["aux"]["mutated"])


# --------------------------------------------------------------------- #
# Optimizer steps: the port's Trainer against the JAX train_step        #
# --------------------------------------------------------------------- #

STEPS = 3


def _train_config():
    config = make_synthetic_config(
        data_root="/nonexistent", output_root="/nonexistent", height=32, width=32,
        actions_count=3, batch_size=B, observations_count=T, observation_stacking=2,
        hidden_state_size=8, state_features=8, pretraining_steps=0)
    Configuration(config=config).check_config(check_data_root=False)
    return config


def _initial_jax_state(jax_tr, variables):
    return JaxTrainState(params=variables["params"],
                         opt_state=jax_tr.tx.init(variables["params"]),
                         batch_stats=variables["batch_stats"],
                         model_state=variables["model_state"],
                         mi_matrix=jax_losses.init_mi_matrix(3), step=jnp.zeros((), jnp.int32))


@pytest.fixture(scope="module")
def jax_train_steps(tiny_model, weights):
    """The JAX trainer (smooth MI) and its jitted train step per phase,
    each traced on its first call."""
    jax_tr = jax_trainer.Trainer(_train_config(), tiny_model, NullDataset(), Logger(),
                                 smooth_mi=True, vgg_variables=weights[1])
    return jax_tr, {phase: jax_tr._make_train_step(phase) for phase in (False, True)}


@pytest.fixture(scope="module")
def train_runs(tiny_model, weights, batch, jax_train_steps):
    """Three full-phase steps of both trainers (smooth MI) from the same
    state; returns per step the JAX state and metrics and the port's
    metrics, and the port trainer after the first step's state."""
    variables, vgg_variables = weights
    config = _train_config()
    jax_tr, steps = jax_train_steps
    step = steps[False]
    state = _initial_jax_state(jax_tr, variables)

    port = Trainer(config, _port_model(tiny_model, variables, False), smooth_mi=True,
                   vgg=_port_vgg(vgg_variables))
    port.init_state()
    initial = {k: v.detach().clone() for k, v in port.model.state_dict().items()}
    obs, acts = batch
    runs = []
    for _ in range(STEPS):
        NOISE.reset()
        got = port.train_step(type("Batch", (), dict(observations=obs, actions=acts)))
        NOISE.reset()
        state, metrics = step(state, jnp.asarray(obs), jnp.asarray(acts),
                              jnp.asarray(got["ground_truth_observations"], jnp.int32),
                              jnp.asarray(got["gumbel_temperature"], jnp.float32),
                              jax.random.PRNGKey(0), jax_tr.vgg_variables)
        metrics.pop("_plot_arrays")
        runs.append(dict(port=got, jax_metrics=jax.device_get(metrics),
                         jax_state=jax.device_get(state),
                         port_params={k: v.detach().clone()
                                      for k, v in port.model.state_dict().items()},
                         port_mi=port.state.mi_matrix.clone(),
                         port_grads={k: v.grad.clone()
                                     for k, v in port.model.named_parameters()}))
    runs[0]["initial"] = initial
    return runs


def test_one_adam_step_matches_jax_train_step(train_runs):
    """Each parameter's update, the BatchNorm statistics, centroids and the
    MI matrix after one step, and the step's loss and gradient norms."""
    run = train_runs[0]
    state = run["jax_state"]
    port_state, initial = run["port_params"], run["initial"]
    training = _train_config()["training"]
    lr, eps = training["learning_rate"], 1e-8
    for path, value in _leaves(state.params):
        key, value = _convert("params", path, value)
        before = initial[key].numpy()
        got, want = port_state[key].numpy() - before, value - before
        # Adam's first step is -lr * g / (|g| + eps), with g the gradient
        # plus the weight decay: +-lr where |g| >> eps, steep where |g| is a
        # few hundred eps.  The gradients agree to ``delta``: the tolerance
        # of test_parameter_gradients_match_jax, plus eps for gradients that
        # vanish (mean_fc's bias: both sides are rounding noise, 2e-9 apart).
        # So the updates agree to delta times the steepest slope within
        # delta of g, plus the rounding of the updated parameter on each
        # side.  A skipped or sign-flipped update is off by lr or 2 lr.
        g = np.abs(run["port_grads"][key].numpy() + training["weight_decay"] * before)
        delta = 2e-3 * g + GRAD_ATOL[False] * g.max() + eps
        slope = eps / (np.maximum(g - delta, 0) + eps) ** 2
        bound = lr * delta * slope + 2 * np.spacing(np.abs(before).max())
        excess = np.abs(got - want) - bound
        assert excess.max() <= 0, (key, np.abs(got - want).flat[excess.argmax()],
                                   bound.flat[excess.argmax()])
    for collection, tree in (("batch_stats", state.batch_stats),
                             ("model_state", state.model_state)):
        for path, value in _leaves(tree):
            key, value = _convert(collection, path, value)
            np.testing.assert_allclose(port_state[key].numpy(), value, err_msg=key, **TOL)
    np.testing.assert_allclose(run["port_mi"].numpy(), state.mi_matrix, **TOL)
    metrics = run["jax_metrics"]
    norms = [k for k in metrics if k.startswith("grad_norm/")]
    assert len(norms) == 6
    for key in norms + ["loss"]:
        np.testing.assert_allclose(run["port"][key], metrics[key], err_msg=key, rtol=2e-3)


def test_loss_trajectory_matches_jax(train_runs):
    got = [run["port"]["loss"] for run in train_runs]
    want = [float(run["jax_metrics"]["loss"]) for run in train_runs]
    np.testing.assert_allclose(got, want, **TOL)
    assert got[0] != got[1] != got[2]
    assert [run["port"]["ground_truth_observations"] for run in train_runs] == [3, 3, 3]


def _jax_variables_of(model, template):
    """The port model's parameters and buffers as a JAX variables tree
    shaped like ``template`` (the inverse of ``load_jax_variables``)."""
    state = model.state_dict()

    def walk(collection, node, path):
        tree = {}
        for name, value in node.items():
            if isinstance(value, dict):
                tree[name] = walk(collection, value, path + (name,))
                continue
            key, _ = _convert(collection, path + (name,), np.asarray(value))
            array = state[key].detach().numpy().copy()  # not a view of the live tensor
            if name.startswith("initial_"):
                array = array.transpose(1, 2, 0)
            elif name == "kernel":
                array = array.transpose(2, 3, 1, 0) if array.ndim == 4 else array.T
            tree[name] = array
        return tree

    return {c: walk(c, template[c], ()) for c in ("params", "batch_stats", "model_state")}


def test_training_loop_loss_trajectory_matches_jax(tiny_model, weights, jax_train_steps,
                                                   synthetic_dataset_dir):
    """The port's epoch loop, one pretraining and two full-phase steps over
    its loader's batches: each step's loss against the JAX train step's on
    the same batch, schedules, noise, weights, statistics, centroids and MI
    matrix (the port's state before that step), rtol 1e-3.

    Each JAX step starts from the port's state rather than carrying its own:
    Adam's first update is about lr * sign(g), and pretraining's gradients
    are ill-conditioned (module docstring), so weights 1e-6 apart drift
    apart by up to 2 lr after the first step; on this model such a
    perturbation of the port's own weights moves its third loss by up to
    3.5e-3 relative."""
    variables, vgg_variables = weights
    jax_tr, steps = jax_train_steps
    config = _train_config()
    config["training"]["pretraining_steps"] = 1
    dataset = VideoDataset(os.path.join(synthetic_dataset_dir, "train"),
                           config["training"]["batching"], get_final_transforms(config)["train"])
    port = Trainer(config, _port_model(tiny_model, variables, False), smooth_mi=True,
                   vgg=_port_vgg(vgg_variables), dataset=dataset)
    port.init_state()
    recorded = []
    train_step = port.train_step

    def step(batch):
        before = (_jax_variables_of(port.model, variables), port.state.mi_matrix.numpy().copy())
        NOISE.reset()
        metrics = train_step(batch)
        recorded.append((batch, before, dict(metrics)))
        return metrics

    port.train_step = step
    port.train_epoch(max_steps=3)
    assert port.global_step == 3
    assert [m["pretraining"] for *_, m in recorded] == [1.0, 0.0, 0.0]

    got, want = [], []
    for batch, (before, mi_matrix), metrics in recorded:
        state = _initial_jax_state(jax_tr, before).replace(mi_matrix=jnp.asarray(mi_matrix))
        NOISE.reset()
        _, jax_metrics = steps[bool(metrics["pretraining"])](
            state, jnp.asarray(batch.observations), jnp.asarray(batch.actions),
            jnp.asarray(metrics["ground_truth_observations"], jnp.int32),
            jnp.asarray(metrics["gumbel_temperature"], jnp.float32), jax.random.PRNGKey(0),
            jax_tr.vgg_variables)
        got.append(metrics["loss"])
        want.append(float(jax_metrics["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[0] != got[1] != got[2]
