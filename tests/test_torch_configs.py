"""The paper's Breakout and Tennis experiments (``configs/02_breakout.yaml``,
``configs/03_tennis.yaml``) in the port against the JAX package, on the
CPU, and ``chip_smoke.py`` phase 20's copies of their configs and kernel
shapes pinned to the files and the models.

- Play: three chained play steps of each config's model, built through
  both packages' registries from the YAML with only the frames cut, in
  f32 with the same seeded weights: the tennis model (hidden 128, 64
  state features, a 5-D action space, 7 actions, stacking 4) at 32x64
  (state 4x8; frames still wider than tall; 24x64 would give a state of
  3x8, whose odd height neither package's hourglass takes) and the
  reduced model (hidden 64, a 1-D action space, 3 actions) at 48x32 (as
  tests/test_torch_reduced_model.py cuts it).  Frames, carries and
  windows at tests/test_torch_play.py's rtol 1e-3 / atol 2e-4.
- Train: the plain trainer (``training.trainer``, smooth MI off, through
  both registries) with the tennis config's loss weights (the
  action-state KL on), its 5-D action space, stacking 4 and skip 4 (the
  batch of seeded noise read through the port's dataset), at narrow widths
  (hidden 16, 16 state features, 32x64 frames) so that JAX's compile
  stays short: a pretraining step and a full-phase step, each from the
  same seeded state, against the JAX train step with the same noise.  The loss, every term
  and diagnostic at rtol 1e-3 / atol 2e-4, the gradient norms at rtol
  2e-3, the BatchNorm statistics and centroids after the step at rtol
  1e-3 / atol 2e-4, as tests/test_torch_reduced_model.py holds them.
"""
import copy
import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_play import _play_steps
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    NOISE, patched_noise, random_variables, single_threaded_torch)

import chip_smoke
from playablevideogeneration_tpu.config import registry as jax_registry
from playablevideogeneration_tpu.config.configuration import Configuration as JaxConfiguration
from playablevideogeneration_tpu.data.synthetic import make_synthetic_config
from playablevideogeneration_tpu.models import vgg as jax_vgg
from playablevideogeneration_tpu.models.caddy import init_model_variables
from playablevideogeneration_tpu.training import losses as jax_losses
from playablevideogeneration_tpu.training.bench_harness import NullDataset
from playablevideogeneration_tpu.training.train_state import TrainState as JaxTrainState
from playablevideogeneration_tpu.utils.logging import Logger as JaxLogger
from playablevideogeneration_tpu_torch.config import registry
from playablevideogeneration_tpu_torch.data.transforms import get_final_transforms
from playablevideogeneration_tpu_torch.data.video import Video
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset, collate
from playablevideogeneration_tpu_torch.evaluation.evaluator import evaluation_forward
from playablevideogeneration_tpu_torch.models import layers
from playablevideogeneration_tpu_torch.models.vgg import Vgg19
from playablevideogeneration_tpu_torch.utils.jax_weights import (
    _convert,
    _leaves,
    load_jax_variables,
)
from playablevideogeneration_tpu_torch.utils.logging import Logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-3, atol=2e-4)
FILES = {"breakout": "02_breakout.yaml", "tennis": "03_tennis.yaml"}
# The keys that PAPER_OVERRIDES may set: step counts and batch counts.
STEP_AND_BATCH_COUNTS = {("training", "pretraining_steps"), ("training", "max_steps"),
                         ("training", "save_freq"), ("evaluation", "eval_freq"),
                         ("evaluation", "max_evaluation_batches")}


def _yaml(*path):
    with open(os.path.join(REPO, "configs", *path)) as f:
        return yaml.safe_load(f)


def _cut(name: str, height: int, width: int) -> dict:
    """The config with its frames cut to height x width (state at an
    eighth), in f32."""
    config = _yaml(FILES[name])
    network = config["model"]["representation_network"]
    network["target_input_size"] = [width, height]
    network["state_resolution"] = [height // 8, width // 8]
    config["tpu"]["compute_dtype"] = "float32"
    return config


@pytest.mark.parametrize("name", sorted(FILES))
def test_chip_smoke_paper_configs_are_the_yaml_but_their_overrides(name, tmp_path):
    """``chip_smoke.py`` builds the configs as dicts (the card's machine has
    no PyYAML): each must be its file, and phase 20's run config the YAML's
    with only step counts, batch counts and the roots changed, so widths,
    frame sizes, batch sizes, stacking, skip and loss weights stay the
    file's."""
    run = chip_smoke.PAPER_RUNS[name]
    want = _yaml(FILES[name])
    assert run.config == want
    assert run.evaluation == _yaml("evaluation", FILES[name])
    assert set(chip_smoke.PAPER_OVERRIDES) <= STEP_AND_BATCH_COUNTS
    root = str(tmp_path)
    for (section, key), value in {**chip_smoke.PAPER_OVERRIDES,
                                  **chip_smoke.loop_roots(root)}.items():
        assert want[section].get(key) != value, (section, key)
        want[section][key] = value
    JaxConfiguration(config=want).check_config(check_data_root=False)
    for (section, key), value in chip_smoke.CHECKED_OVERRIDES.items():
        want[section][key] = value
    assert chip_smoke.loop_config(root, run.config, chip_smoke.PAPER_OVERRIDES) == want


@pytest.mark.parametrize("name", sorted(FILES))
def test_chip_smoke_paper_videos_fill_the_batches(name, tmp_path):
    """Phase 20's synthetic splits: the train split gives a batch at the
    full length and at the first steps' 7 frames (the skip spreading them),
    the validation split one evaluation batch, and the test split exactly
    one builder batch, whose sequences the offline evaluation takes one
    each."""
    run = chip_smoke.PAPER_RUNS[name]
    config = chip_smoke.loop_config(str(tmp_path), run.config, chip_smoke.PAPER_OVERRIDES)
    datasets = chip_smoke.loop_datasets(config, run.videos, run.fixed_row)
    train, evaluation = config["training"]["batching"], config["evaluation"]["batching"]
    for frames in (train["observations_count"], train["observations_count_start"]):
        datasets["train"].set_observations_count(frames)
        assert len(datasets["train"]) >= train["batch_size"], frames
    datasets["train"].set_observations_count(train["observations_count_start"])
    steps = config["training"]["max_steps"]
    assert len(datasets["train"]) // train["batch_size"] >= steps
    assert len(datasets["validation"]) >= evaluation["batch_size"]
    assert len(datasets["test"]) == evaluation["batch_size"]
    sample = datasets["test"][0]
    width, height = config["model"]["representation_network"]["target_input_size"]
    assert sample.observations.shape == (evaluation["observations_count"], height, width,
                                         3 * evaluation["observation_stacking"])


@pytest.mark.parametrize("name", sorted(FILES))
def test_chip_smoke_paper_kernel_shapes_are_the_models(name, monkeypatch):
    """Phase 20's K1 and K3 shapes (``PaperRun.gates``, ``.norms``) are
    those at which the config's model, at full width, calls the kernels'
    wrappers in a play step at batch 1, in order; an evaluation forward of
    B x T calls K3 at ``eval_norm_shapes(B, T, norms)``; and phase 3 holds
    K3 at Breakout's 13x10, whose rows no pack divides."""
    run = chip_smoke.PAPER_RUNS[name]
    calls = {"gates": [], "norm": []}

    def counted(key, fn):
        def wrapped(*args):
            calls[key].append(tuple(args[1 if key == "gates" else 0].shape))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(layers, "fused_lstm_gates", counted("gates", layers.fused_lstm_gates))
    monkeypatch.setattr(layers, "fused_batch_norm_leaky_relu",
                        counted("norm", layers.fused_batch_norm_leaky_relu))
    config = copy.deepcopy(run.config)
    config["tpu"]["compute_dtype"] = "float32"
    registry._register_defaults()
    model = registry.resolve("model", config["model"]["architecture"])(config, "cpu")
    width, height = config["model"]["representation_network"]["target_input_size"]
    channels = 3 * config["training"]["batching"]["observation_stacking"]
    rng = np.random.default_rng(0)
    with torch.no_grad():
        model.play_step(model.init_play(1), torch.from_numpy(
            rng.uniform(-1, 1, (1, height, width, channels)).astype(np.float32)),
            torch.eye(model.actions_count)[:1], torch.zeros(1, model.action_space_dimension))
    assert calls == {"gates": list(run.gates), "norm": list(run.norms)}

    batch, frames = 1, 3
    calls["norm"] = []
    observations = torch.from_numpy(
        rng.uniform(-1, 1, (batch, frames, channels, height, width)).astype(np.float32))
    evaluation_forward(model, observations, torch.zeros(batch, frames, dtype=torch.long),
                       torch.Generator(), 1, 0.4)
    assert Counter(calls["norm"]) == Counter(
        chip_smoke.eval_norm_shapes(batch, frames, list(run.norms)))
    ragged = [s for s in chip_smoke.paper_kernel_shapes(run)["fused_norm_act"]
              if s[2] * s[3] == chip_smoke.RAGGED_NORM_HW]
    assert bool(ragged) == (name == "breakout")


@pytest.mark.parametrize("name, height, width", [("tennis", 32, 64), ("breakout", 48, 32)])
def test_paper_model_play_steps_match_jax(name, height, width):
    """Three chained play steps of the config's model against the JAX
    model's ``play_step``: frames, carries and windows at rtol 1e-3 / atol
    2e-4."""
    config = _cut(name, height, width)
    architecture = config["model"]["architecture"]
    jax_registry._register_defaults()
    registry._register_defaults()
    jax_model = jax_registry.resolve("model", architecture)(config)
    channels = 3 * jax_model.observation_stacking
    # The initialisation's sequence must outlast the stack's reach.
    frames = jax_model.observation_stacking + 1
    shapes = jax.eval_shape(lambda: init_model_variables(
        jax_model, jax.random.PRNGKey(0), jnp.zeros((1, frames, height, width, channels)),
        jnp.zeros((1, frames), jnp.int32)))
    variables = random_variables(shapes, seed=17)
    port = load_jax_variables(registry.resolve("model", architecture)(config, "cpu"), variables)
    want = {"tennis": (7, 5, 128, 4), "breakout": (3, 1, 64, 1)}[name]
    assert (port.actions_count, port.action_space_dimension, port.hidden_state_size,
            port.observation_stacking) == want
    window = np.random.default_rng(18).uniform(-1, 1, (1, height, width, channels))
    _play_steps(jax_model, variables, port, window.astype(np.float32), steps=3, **TOL)


B, T, HEIGHT, WIDTH = 2, 4, 32, 64


@pytest.fixture(scope="module")
def plain_trainer_setup():
    """The tennis config's training section at narrow widths: (config,
    JAX model, variables, VGG variables, the batch)."""
    tennis = _yaml(FILES["tennis"])
    batching = tennis["training"]["batching"]
    config = make_synthetic_config(
        data_root="/nonexistent", output_root="/nonexistent", height=HEIGHT, width=WIDTH,
        actions_count=tennis["data"]["actions_count"], batch_size=B, observations_count=T,
        observation_stacking=batching["observation_stacking"], hidden_state_size=16,
        state_features=16,
        action_space_dimension=tennis["model"]["action_network"]["action_space_dimension"],
        pretraining_steps=1)
    config["training"].update(trainer=tennis["training"]["trainer"],
                              loss_weights=tennis["training"]["loss_weights"],
                              ground_truth_observations_start=2,
                              ground_truth_observations_end=2)
    config["training"]["batching"]["skip_frames"] = batching["skip_frames"]
    assert config["training"]["loss_weights"]["action_state_distribution_kl_lambda"] > 0
    JaxConfiguration(config=config).check_config(check_data_root=False)
    # The batch through the port's dataset: T observations 5 frames apart,
    # each a stack of 4 going back by 5, from videos of seeded noise (the
    # flat background of moving-square videos leaves train-mode
    # BatchNorm's variances to f32 cancellation, which the two frameworks
    # round apart by percents in the gradients).
    stride = batching["skip_frames"] + 1
    rng = np.random.default_rng(21)
    length = T * stride + 2
    videos = [Video().add_content(
        list(rng.integers(0, 256, (length, HEIGHT, WIDTH, 3), dtype=np.uint8)),
        rng.integers(0, 7, length).tolist(), [0.0] * length, [{}] * length,
        [False] * length) for _ in range(B)]
    dataset = VideoDataset.from_videos(videos, config["training"]["batching"],
                                       get_final_transforms(config)["train"])
    samples = collate([dataset[i * len(dataset) // B + 2] for i in range(B)])
    obs, acts = samples.observations, samples.actions.astype(np.int32)
    assert obs.shape == (B, T, HEIGHT, WIDTH, 12)
    jax_registry._register_defaults()
    jax_model = jax_registry.resolve("model", config["model"]["architecture"])(config)
    shapes = jax.eval_shape(lambda: init_model_variables(
        jax_model, jax.random.PRNGKey(0), jnp.asarray(obs), jnp.asarray(acts)))
    variables = random_variables(shapes, seed=19)
    vgg_variables = random_variables(
        jax.eval_shape(jax_vgg.random_vgg_variables, jax.random.PRNGKey(0)), seed=20)
    return config, jax_model, variables, vgg_variables, (obs, acts)


@pytest.mark.parametrize("pretraining", [True, False])
def test_plain_trainer_step_matches_jax(plain_trainer_setup, pretraining):
    """One step of the plain trainer from the seeded state, pretraining or
    full phase, against the JAX train step (module docstring)."""
    config, jax_model, variables, vgg_variables, (obs, acts) = plain_trainer_setup
    config = copy.deepcopy(config)
    config["training"]["pretraining_steps"] = int(pretraining)
    registry._register_defaults()
    model = load_jax_variables(
        registry.resolve("model", config["model"]["architecture"])(config, "cpu"), variables)
    trainer = registry.resolve("trainer", config["training"]["trainer"])(
        config, model, None, Logger(), vgg=load_jax_variables(Vgg19(), vgg_variables))
    assert not trainer.smooth_mi
    trainer.init_state()
    jax_trainer = jax_registry.resolve("trainer", config["training"]["trainer"])(
        config, jax_model, NullDataset(), JaxLogger(), vgg_variables=vgg_variables)
    assert not jax_trainer.smooth_mi
    state = JaxTrainState(params=variables["params"],
                          opt_state=jax_trainer.tx.init(variables["params"]),
                          batch_stats=variables["batch_stats"],
                          model_state=variables["model_state"],
                          mi_matrix=jax_losses.init_mi_matrix(7), step=jnp.zeros((), jnp.int32))
    with patched_noise():
        NOISE.reset()
        got = trainer.train_step(type("Batch", (), dict(observations=obs, actions=acts)))
        NOISE.reset()
        state, want = jax_trainer._make_train_step(pretraining)(
            state, jnp.asarray(obs), jnp.asarray(acts),
            jnp.asarray(got["ground_truth_observations"], jnp.int32),
            jnp.asarray(got["gumbel_temperature"], jnp.float32), jax.random.PRNGKey(0),
            jax_trainer.vgg_variables)
    want = jax.device_get(want)
    want.pop("_plot_arrays")
    assert got["pretraining"] == float(pretraining) and got["ground_truth_observations"] == 2
    shared = [k for k in want if k in got and np.ndim(want[k]) == 0]
    assert "loss" in shared and "action_state_distribution_kl_loss" in shared
    assert len([k for k in shared if k.startswith("grad_norm/")]) >= 5
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
