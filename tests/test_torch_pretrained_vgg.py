"""The perceptual loss's VGG19 as the config names it, in the port's
trainer, evaluators and training CLI against the JAX package's, on the CPU.

Both packages' ``Trainer`` and ``Evaluator`` are built without an explicit
VGG.  A random VGG19 tree, seeded apart from the port's seeded fallbacks,
is written by the JAX package's ``save_variables_npz`` and found through
``PVG_PRETRAINED_WEIGHTS``.  The conftest tiny model gets the same seeded
numpy weights in both packages, the same batch and the same noise
(``torch_parity.patched_noise``).  One full-phase train step's perceptual
term and total loss agree within rtol 1e-3 / atol 2e-4 (f32, as
test_torch_train.py), one evaluation batch's perceptual losses within rtol
1e-3 (as test_torch_eval.py).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    NOISE, patched_noise, random_variables, single_threaded_torch)

from playablevideogeneration_tpu.config.configuration import Configuration as JaxConfiguration
from playablevideogeneration_tpu.data import transforms as jax_transforms
from playablevideogeneration_tpu.data.synthetic import make_synthetic_config
from playablevideogeneration_tpu.data.video_dataset import VideoDataset as JaxVideoDataset
from playablevideogeneration_tpu.evaluation import action_sampler as jax_samplers
from playablevideogeneration_tpu.evaluation.evaluator import Evaluator as JaxEvaluator
from playablevideogeneration_tpu.models import vgg as jax_vgg
from playablevideogeneration_tpu.training import losses as jax_losses
from playablevideogeneration_tpu.training import trainer as jax_trainer
from playablevideogeneration_tpu.training.bench_harness import NullDataset
from playablevideogeneration_tpu.training.train_state import TrainState as JaxTrainState
from playablevideogeneration_tpu.utils import pretrained as jax_pretrained
from playablevideogeneration_tpu.utils.logging import Logger as JaxLogger
from playablevideogeneration_tpu_torch.cli.train import build_run
from playablevideogeneration_tpu_torch.data.transforms import make_train_transform
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset
from playablevideogeneration_tpu_torch.evaluation import action_sampler as samplers
from playablevideogeneration_tpu_torch.evaluation.evaluator import Evaluator
from playablevideogeneration_tpu_torch.models.caddy import Caddy
from playablevideogeneration_tpu_torch.models.vgg import make_vgg
from playablevideogeneration_tpu_torch.training.trainer import Trainer
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables
from playablevideogeneration_tpu_torch.utils.logging import Logger
from playablevideogeneration_tpu_torch.utils.pretrained import make_metric_vgg

TOL = dict(rtol=1e-3, atol=2e-4)
B, T = 2, 4
WARNING = "WARNING: no pretrained VGG weights provided"


@pytest.fixture(scope="module", autouse=True)
def shared_noise():
    with patched_noise():
        yield


@pytest.fixture(scope="module")
def weights(tiny_variables):
    """Seeded numpy model and VGG variables (shapes from the JAX inits)."""
    vgg_shapes = jax.eval_shape(jax_vgg.random_vgg_variables, jax.random.PRNGKey(0))
    return random_variables(tiny_variables, seed=41), random_variables(vgg_shapes, seed=42)


@pytest.fixture(scope="module")
def vgg_dir(tmp_path_factory, weights):
    """A pretrained-weights directory holding the VGG tree as ``vgg19.npz``,
    whose weights are neither of the port's seeded fallbacks."""
    directory = tmp_path_factory.mktemp("pretrained")
    jax_pretrained.save_variables_npz(weights[1], str(directory / "vgg19.npz"))
    for fallback in (make_vgg("cpu", torch.float32, 0), make_metric_vgg(None, "cpu")):
        assert not np.allclose(fallback.conv0.weight.numpy(),
                               weights[1]["params"]["conv0"]["kernel"].transpose(3, 2, 0, 1))
    return str(directory)


def _assert_vgg_is(vgg, variables, dtype):
    """``vgg`` holds ``variables``' weights exactly and computes in ``dtype``."""
    want = load_jax_variables(make_vgg("cpu"), variables).state_dict()
    got = vgg.state_dict()
    assert list(got) == list(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    assert all(conv.compute_dtype == dtype for conv in vgg.children())


def _port_model(tiny_model, variables, dtype=torch.float32):
    model = Caddy(tiny_model.actions_count, tiny_model.action_space_dimension,
                  tiny_model.state_features, tiny_model.state_resolution,
                  tiny_model.hidden_state_size, tiny_model.observation_stacking, dtype=dtype)
    return load_jax_variables(model, variables)


def _config(data_root="/nonexistent", output_root="/nonexistent"):
    config = make_synthetic_config(
        data_root=data_root, output_root=output_root, height=32, width=32, actions_count=3,
        batch_size=B, observations_count=T, observation_stacking=2, hidden_state_size=8,
        state_features=8, pretraining_steps=0)
    config["evaluation"]["max_evaluation_batches"] = 1
    JaxConfiguration(config=config).check_config(check_data_root=False)
    return config


def test_train_step_with_configured_vgg_matches_jax(tiny_model, weights, vgg_dir, monkeypatch,
                                                    capsys):
    """Both trainers load the file's VGG19, the port's in the model's dtype,
    without the random-VGG warning; one full-phase step from the same state
    gives the same perceptual term and total loss."""
    monkeypatch.setenv("PVG_PRETRAINED_WEIGHTS", vgg_dir)
    variables, vgg_variables = weights
    config = _config()
    jax_tr = jax_trainer.Trainer(config, tiny_model, NullDataset(), JaxLogger(), smooth_mi=True)
    port = Trainer(config, _port_model(tiny_model, variables).train(), smooth_mi=True)
    printed = capsys.readouterr().out
    assert WARNING not in printed
    assert printed.count(f"Loading pretrained VGG19 weights from {vgg_dir}") == 2
    _assert_vgg_is(port.vgg, vgg_variables, torch.float32)

    rng = np.random.default_rng(6)
    obs = rng.uniform(-1, 1, (B, T, 32, 32, 6)).astype(np.float32)
    acts = rng.integers(0, 3, (B, T)).astype(np.int32)
    port.init_state()
    NOISE.reset()
    got = port.train_step(type("Batch", (), dict(observations=obs, actions=acts)))
    state = JaxTrainState(params=variables["params"],
                          opt_state=jax_tr.tx.init(variables["params"]),
                          batch_stats=variables["batch_stats"],
                          model_state=variables["model_state"],
                          mi_matrix=jax_losses.init_mi_matrix(3), step=jnp.zeros((), jnp.int32))
    NOISE.reset()
    _, want = jax_tr._make_train_step(False)(
        state, jnp.asarray(obs), jnp.asarray(acts),
        jnp.asarray(got["ground_truth_observations"], jnp.int32),
        jnp.asarray(got["gumbel_temperature"], jnp.float32), jax.random.PRNGKey(0),
        jax_tr.vgg_variables)
    assert got["pretraining"] == 0.0
    for key in ("loss_component_perceptual_loss", "avg_perceptual_loss", "loss"):
        np.testing.assert_allclose(got[key], float(want[key]), err_msg=key, **TOL)


def test_evaluation_batch_with_configured_vgg_matches_jax(tiny_model, weights, vgg_dir,
                                                          synthetic_dataset_dir, tmp_path,
                                                          monkeypatch):
    """Both evaluators load the file's VGG19 in f32; one evaluation batch
    with the one-hot sampler gives the same perceptual losses, averaged and
    per position."""
    monkeypatch.setenv("PVG_PRETRAINED_WEIGHTS", vgg_dir)
    config = _config(synthetic_dataset_dir, str(tmp_path))
    val = os.path.join(synthetic_dataset_dir, "val")
    batching = config["evaluation"]["batching"]
    jax_eval = JaxEvaluator(
        copy.deepcopy(config), tiny_model,
        JaxVideoDataset(val, batching, jax_transforms.make_train_transform(None, (32, 32))),
        JaxLogger(), logger_prefix="validation")
    port = Evaluator(config, _port_model(tiny_model, weights[0]),
                     VideoDataset(val, batching, make_train_transform(None, (32, 32))), Logger(),
                     logger_prefix="validation")
    _assert_vgg_is(port.vgg, weights[1], torch.float32)
    forward = port._forward

    def fresh_noise_forward(*args):
        NOISE.reset()
        return forward(*args)

    port._forward = fresh_noise_forward
    port.set_action_sampler(samplers.one_hot_action_sampler, label="one_hot")
    jax_eval.set_action_sampler(jax_samplers.one_hot_action_sampler, label="one_hot")
    got = port.evaluate(3, save_images=False)
    NOISE.reset()
    want = jax_eval.evaluate(weights[0], 3, save_images=False)
    keys = [k for k in want if "perceptual_loss" in k]
    assert sorted(keys) == sorted(k for k in got if "perceptual_loss" in k)
    assert len(keys) == 1 + batching["observations_count"]  # the average and each position
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)


def test_build_run_shares_the_configured_vgg(tiny_variables, weights, vgg_dir,
                                             synthetic_dataset_dir, tmp_path, monkeypatch):
    """``cli.train.build_run`` on a bf16 model: the trainer's VGG19 is the
    file's computing in bf16, and both evaluators share one, in f32."""
    monkeypatch.setenv("PVG_PRETRAINED_WEIGHTS", vgg_dir)
    config = _config(synthetic_dataset_dir, str(tmp_path))
    config["tpu"] = {"compute_dtype": "bfloat16"}
    _, _, trainer, evaluators, _ = build_run(config, device="cpu")
    _assert_vgg_is(trainer.vgg, weights[1], torch.bfloat16)
    assert evaluators["validation"].vgg is evaluators["test"].vgg
    _assert_vgg_is(evaluators["validation"].vgg, weights[1], torch.float32)


def _build(which, config, tiny_model, weights, synthetic_dataset_dir):
    batching = config["evaluation"]["batching"]
    val = os.path.join(synthetic_dataset_dir, "val")
    if which == "jax_trainer":
        return jax_trainer.Trainer(config, tiny_model, NullDataset(), JaxLogger())
    if which == "jax_evaluator":
        return JaxEvaluator(
            config, tiny_model,
            JaxVideoDataset(val, batching, jax_transforms.make_train_transform(None, (32, 32))),
            JaxLogger())
    model = _port_model(tiny_model, weights[0])
    if which == "port_trainer":
        return Trainer(config, model)
    return Evaluator(config, model,
                     VideoDataset(val, batching, make_train_transform(None, (32, 32))), Logger())


@pytest.mark.parametrize("which", ["port_trainer", "port_evaluator", "jax_trainer",
                                   "jax_evaluator"])
def test_missing_configured_vgg_raises(tiny_model, weights, synthetic_dataset_dir, tmp_path,
                                       which):
    config = _config(synthetic_dataset_dir, str(tmp_path))
    config["tpu"] = {"pretrained_weights": {"vgg19": str(tmp_path / "missing.npz")}}
    with pytest.raises(FileNotFoundError, match="tpu.pretrained_weights.vgg19"):
        _build(which, config, tiny_model, weights, synthetic_dataset_dir)


@pytest.mark.parametrize("found", [True, False], ids=["weights", "no_weights"])
@pytest.mark.parametrize("package", ["port", "jax"])
def test_trainer_warns_only_without_vgg_weights(tiny_model, weights, vgg_dir,
                                                synthetic_dataset_dir, monkeypatch, capsys,
                                                package, found):
    """The random-VGG warning, as the JAX trainer prints it, only when no
    weights are found; the port then keeps its VGG19 seeded from the run's
    seed."""
    if found:
        monkeypatch.setenv("PVG_PRETRAINED_WEIGHTS", vgg_dir)
    else:
        monkeypatch.delenv("PVG_PRETRAINED_WEIGHTS", raising=False)
    trainer = _build(f"{package}_trainer", _config(), tiny_model, weights, synthetic_dataset_dir)
    assert (WARNING in capsys.readouterr().out) == (not found)
    if package == "port" and found:
        _assert_vgg_is(trainer.vgg, weights[1], torch.float32)
    elif package == "port":
        got = trainer.vgg.state_dict()
        for key, value in make_vgg("cpu", torch.float32, 0).state_dict().items():
            assert torch.equal(got[key], value), key
