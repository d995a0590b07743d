"""One training step of the reduced model (``configs/02_breakout.yaml``'s
widths: hidden 64, 64 state features, a 1-D action space, 3 actions,
stacking 1), built through each package's registry from the config's
``model.reduced_model.model``, against the JAX train step, on the CPU.

Only the frames are cut, 208x160 to 48x32 (state 26x20 to 6x4), keeping
them taller than wide.  The same seeded weights, batch and noise on both
sides; the loss, every term and diagnostic rtol 1e-3 / atol 2e-4, the
gradient norms rtol 2e-3 (as tests/test_torch_train.py), and the
BatchNorm statistics, centroids and MI matrix after the step at rtol 1e-3
/ atol 2e-4.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    NOISE, patched_noise, random_variables, single_threaded_torch)

from playablevideogeneration_tpu.config import registry as jax_registry
from playablevideogeneration_tpu.config.configuration import Configuration
from playablevideogeneration_tpu.data.synthetic import make_synthetic_config
from playablevideogeneration_tpu.models import vgg as jax_vgg
from playablevideogeneration_tpu.models.caddy import init_model_variables
from playablevideogeneration_tpu.training import losses as jax_losses
from playablevideogeneration_tpu.training.bench_harness import NullDataset
from playablevideogeneration_tpu.training.train_state import TrainState as JaxTrainState
from playablevideogeneration_tpu.utils.logging import Logger as JaxLogger
from playablevideogeneration_tpu_torch.config import registry
from playablevideogeneration_tpu_torch.models.vgg import Vgg19
from playablevideogeneration_tpu_torch.utils.jax_weights import (
    _convert,
    _leaves,
    load_jax_variables,
)
from playablevideogeneration_tpu_torch.utils.logging import Logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-3, atol=2e-4)
B, T, HEIGHT, WIDTH = 2, 4, 48, 32


@pytest.fixture(scope="module")
def config():
    with open(os.path.join(REPO, "configs", "02_breakout.yaml")) as f:
        breakout = yaml.safe_load(f)
    model = breakout["model"]
    config = make_synthetic_config(
        data_root="/nonexistent", output_root="/nonexistent", height=HEIGHT, width=WIDTH,
        actions_count=breakout["data"]["actions_count"], batch_size=B, observations_count=T,
        observation_stacking=1, hidden_state_size=model["dynamics_network"]["hidden_state_size"],
        state_features=model["representation_network"]["state_features"],
        action_space_dimension=model["action_network"]["action_space_dimension"],
        pretraining_steps=0)
    assert config["model"]["architecture"] == breakout["model"]["architecture"]
    config["training"]["trainer"] = breakout["training"]["trainer"]
    config["training"]["ground_truth_observations_start"] = 2
    config["training"]["ground_truth_observations_end"] = 2
    Configuration(config=config).check_config(check_data_root=False)
    return config


def test_reduced_model_train_step_matches_jax(config):
    jax_registry._register_defaults()
    registry._register_defaults()
    architecture = config["model"]["architecture"]
    jax_model = jax_registry.resolve("model", architecture)(config)
    assert (jax_model.hidden_state_size, jax_model.action_space_dimension) == (64, 1)
    rng = np.random.default_rng(13)
    obs = rng.uniform(-1, 1, (B, T, HEIGHT, WIDTH, 3)).astype(np.float32)
    acts = rng.integers(0, 3, (B, T)).astype(np.int32)
    shapes = jax.eval_shape(lambda: init_model_variables(
        jax_model, jax.random.PRNGKey(0), jnp.asarray(obs), jnp.asarray(acts)))
    variables = random_variables(shapes, seed=14)
    vgg_variables = random_variables(
        jax.eval_shape(jax_vgg.random_vgg_variables, jax.random.PRNGKey(0)), seed=15)

    model = load_jax_variables(registry.resolve("model", architecture)(config, "cpu"), variables)
    assert model.state_resolution == (6, 4) and model.action_space_dimension == 1
    trainer = registry.resolve("trainer", config["training"]["trainer"])(
        config, model, None, Logger(), vgg=load_jax_variables(Vgg19(), vgg_variables))
    assert trainer.smooth_mi
    trainer.init_state()
    jax_trainer = jax_registry.resolve("trainer", config["training"]["trainer"])(
        config, jax_model, NullDataset(), JaxLogger(), vgg_variables=vgg_variables)
    state = JaxTrainState(params=variables["params"],
                          opt_state=jax_trainer.tx.init(variables["params"]),
                          batch_stats=variables["batch_stats"],
                          model_state=variables["model_state"],
                          mi_matrix=jax_losses.init_mi_matrix(3), step=jnp.zeros((), jnp.int32))

    with patched_noise():
        NOISE.reset()
        got = trainer.train_step(type("Batch", (), dict(observations=obs, actions=acts)))
        NOISE.reset()
        state, want = jax_trainer._make_train_step(False)(
            state, jnp.asarray(obs), jnp.asarray(acts),
            jnp.asarray(got["ground_truth_observations"], jnp.int32),
            jnp.asarray(got["gumbel_temperature"], jnp.float32), jax.random.PRNGKey(0),
            jax_trainer.vgg_variables)
    want = jax.device_get(want)
    want.pop("_plot_arrays")
    assert got["ground_truth_observations"] == 2 and got["pretraining"] == 0.0
    shared = [k for k in want if k in got and np.ndim(want[k]) == 0]
    assert "loss" in shared and len([k for k in shared if k.startswith("grad_norm/")]) == 6
    for key in shared:
        tol = dict(rtol=2e-3) if key.startswith("grad_norm/") else TOL
        np.testing.assert_allclose(got[key], float(want[key]), err_msg=key, **tol)
    buffers = dict(model.named_buffers())
    state = jax.device_get(state)
    for collection, tree in (("batch_stats", state.batch_stats),
                             ("model_state", state.model_state)):
        for path, value in _leaves(tree):
            key, value = _convert(collection, path, value)
            np.testing.assert_allclose(buffers[key].numpy(), value, err_msg=key, **TOL)
    np.testing.assert_allclose(trainer.state.mi_matrix.numpy(), state.mi_matrix, **TOL)
