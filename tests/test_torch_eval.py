"""Parity of the port's in-training evaluation with the JAX package, on the
CPU: the sequence losses, the action samplers, the Hungarian accuracy, the
evaluation forward and ``Evaluator.evaluate``.

The conftest tiny model and the synthetic validation videos, with the same
seeded numpy weights and VGG in both packages and the noise patched to one
numpy source (``torch_parity.patched_noise``); the JAX evaluator's forward
is jitted, so its noise is drawn when it is traced, and every port forward
draws from a freshly reset source.  Tolerances: the forward rtol 1e-3 /
atol 2e-4 in f32, as the play and training routes; losses rtol 1e-5;
metrics rtol 1e-3; samplers, mappings and accuracy exact.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    NOISE, patched_noise, random_variables, single_threaded_torch, to_port_layout)

from playablevideogeneration_tpu.config.configuration import Configuration
from playablevideogeneration_tpu.data import transforms as jax_transforms
from playablevideogeneration_tpu.data.synthetic import make_synthetic_config
from playablevideogeneration_tpu.data.video_dataset import VideoDataset as JaxVideoDataset
from playablevideogeneration_tpu.evaluation import action_sampler as jax_samplers
from playablevideogeneration_tpu.evaluation.evaluator import Evaluator as JaxEvaluator
from playablevideogeneration_tpu.evaluation.hungarian import (
    compute_actions_accuracy as jax_accuracy,
)
from playablevideogeneration_tpu.models import vgg as jax_vgg
from playablevideogeneration_tpu.training import losses as jax_losses
from playablevideogeneration_tpu.utils.logging import Logger as JaxLogger
from playablevideogeneration_tpu_torch.data.transforms import make_train_transform
from playablevideogeneration_tpu_torch.data.video import read_frame
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset
from playablevideogeneration_tpu_torch.evaluation import action_sampler as samplers
from playablevideogeneration_tpu_torch.evaluation.evaluator import Evaluator
from playablevideogeneration_tpu_torch.evaluation.hungarian import compute_actions_accuracy
from playablevideogeneration_tpu_torch.models.caddy import Caddy
from playablevideogeneration_tpu_torch.models.vgg import Vgg19
from playablevideogeneration_tpu_torch.training import losses
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables
from playablevideogeneration_tpu_torch.utils.logging import Logger

TOL = dict(rtol=1e-3, atol=2e-4)
GT_MAPPING = {0: 2, 1: 0, 2: 1}
EVAL_STEP = 3


@pytest.fixture(scope="module", autouse=True)
def shared_noise():
    with patched_noise():
        yield


@pytest.fixture(scope="module")
def weights(tiny_variables):
    vgg_shapes = jax.eval_shape(jax_vgg.random_vgg_variables, jax.random.PRNGKey(0))
    return random_variables(tiny_variables, seed=21), random_variables(vgg_shapes, seed=22)


@pytest.fixture(scope="module")
def config(tmp_path_factory, synthetic_dataset_dir):
    out = tmp_path_factory.mktemp("eval_out")
    config = make_synthetic_config(data_root=synthetic_dataset_dir, output_root=str(out),
                                   height=32, width=32, actions_count=3, observation_stacking=2,
                                   hidden_state_size=8, state_features=8)
    Configuration(config=config).check_config()
    return config


def _port_model(tiny_model, variables):
    model = Caddy(tiny_model.actions_count, tiny_model.action_space_dimension,
                  tiny_model.state_features, tiny_model.state_resolution,
                  tiny_model.hidden_state_size, tiny_model.observation_stacking)
    return load_jax_variables(model, variables)


def _val_path(config):
    return os.path.join(config["data"]["data_root"], "val")


@pytest.fixture(scope="module")
def jax_evaluator(tiny_model, weights, config):
    """One JAX evaluator for the module: its jitted forwards are cached per
    sampler, so the forward and evaluate tests share their programs."""
    batching = config["evaluation"]["batching"]
    dataset = JaxVideoDataset(_val_path(config), batching,
                              jax_transforms.make_train_transform(None, (32, 32)))
    jax_config = copy.deepcopy(config)
    jax_config["logging"]["output_images_directory"] += "_jax"
    return JaxEvaluator(jax_config, tiny_model, dataset, JaxLogger(),
                        logger_prefix="validation", vgg_variables=weights[1])


def _port_evaluator(tiny_model, weights, config, sampler):
    dataset = VideoDataset(_val_path(config), config["evaluation"]["batching"],
                           make_train_transform(None, (32, 32)))
    evaluator = Evaluator(config, _port_model(tiny_model, weights[0]), dataset, Logger(),
                          action_sampler=sampler, logger_prefix="validation",
                          vgg=load_jax_variables(Vgg19(), weights[1]))
    forward = evaluator._forward

    def fresh_noise_forward(*args):
        NOISE.reset()
        return forward(*args)

    evaluator._forward = fresh_noise_forward
    return evaluator


# --------------------------------------------------------------------- #
# Losses, samplers, accuracy                                            #
# --------------------------------------------------------------------- #


def _nchw_sequence(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 1, 4, 2, 3)))


@pytest.mark.parametrize("name", ["observations", "perceptual", "states"])
def test_sequence_loss_matches_jax(weights, name):
    rng = np.random.default_rng(3)
    gt = rng.uniform(-1, 1, (2, 5, 32, 32, 6)).astype(np.float32)
    rec = rng.uniform(-1, 1, (2, 4, 32, 32, 3)).astype(np.float32)
    if name == "observations":
        fns = losses.observations_loss, jax_losses.observations_loss
    elif name == "perceptual":
        vgg = load_jax_variables(Vgg19(), weights[1])
        vgg_apply = jax_vgg.make_vgg_apply(weights[1])
        fns = (lambda a, b: losses.perceptual_loss(vgg, a, b),
               lambda a, b: jax_losses.perceptual_loss(vgg_apply, a, b))
    else:
        fns = losses.states_loss, jax_losses.states_loss
        gt = rng.normal(size=(2, 5, 4, 4, 8)).astype(np.float32)
        rec = rng.normal(size=(2, 5, 4, 4, 8)).astype(np.float32)
    got_avg, got_terms = losses.sequence_loss(fns[0], _nchw_sequence(gt), _nchw_sequence(rec))
    want_avg, want_terms = jax_losses.sequence_loss(fns[1], jnp.asarray(gt), jnp.asarray(rec))
    assert got_terms.shape == want_terms.shape == (5,)
    np.testing.assert_allclose(got_terms.numpy(), np.asarray(want_terms), rtol=1e-5)
    np.testing.assert_allclose(got_avg.item(), float(want_avg), rtol=1e-5)
    if name != "states":
        assert got_terms[0].item() == 0.0  # the ground truth's first frame has no prediction
    with pytest.raises(ValueError, match="incompatible"):
        losses.sequence_loss(fns[0], _nchw_sequence(gt), _nchw_sequence(rec)[:, :2])


def test_action_samplers_match_jax():
    rng = np.random.default_rng(4)
    log_probs = np.log(rng.dirichlet(np.ones(5), size=12)).astype(np.float32)
    log_probs[3, 1] = log_probs[3, 4] = log_probs[3].max() + 1.0  # a tie: the first wins
    ground_truth = rng.integers(0, 7, 12).astype(np.int32)  # some past the mapping's table
    mapping = {0: 4, 1: 0, 3: 2}
    cases = [(samplers.one_hot_action_sampler, jax_samplers.one_hot_action_sampler),
             (samplers.make_ground_truth_action_sampler(mapping),
              jax_samplers.make_ground_truth_action_sampler(mapping))]
    for port_sampler, jax_sampler in cases:
        got = port_sampler(torch.from_numpy(log_probs), torch.from_numpy(ground_truth))
        want = jax_sampler(jnp.asarray(log_probs), jnp.asarray(ground_truth))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    directions = torch.from_numpy(rng.normal(size=(12, 2)).astype(np.float32))
    np.testing.assert_array_equal(
        samplers.zero_action_variation_sampler(directions, None).numpy(),
        np.asarray(jax_samplers.zero_action_variation_sampler(jnp.asarray(directions.numpy()),
                                                              None)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_actions_accuracy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ground_truth = rng.integers(0, 4, 40)
    predictions = np.where(rng.uniform(size=40) < 0.7, (ground_truth + seed) % 4,
                           rng.integers(0, 4, 40))
    got, want = (compute_actions_accuracy(predictions, ground_truth, 4),
                 jax_accuracy(predictions, ground_truth, 4))
    assert got == want
    assert got[0] > 0.5


# --------------------------------------------------------------------- #
# Evaluation forward and Evaluator.evaluate                             #
# --------------------------------------------------------------------- #


def _buffers(model):
    return {k: v.clone() for k, v in model.named_buffers()}


@pytest.mark.parametrize("sampler", ["one_hot", "ground_truth"])
def test_evaluation_forward_matches_jax(tiny_model, weights, config, jax_evaluator, sampler):
    """``model.eval()``, one ground-truth frame, Gumbel temperature 0.4:
    every ModelOutput field against JAX ``apply(train=False)``; the
    BatchNorm statistics and centroids do not move."""
    port_sampler, jax_sampler = {
        "one_hot": (samplers.one_hot_action_sampler, jax_samplers.one_hot_action_sampler),
        "ground_truth": (samplers.make_ground_truth_action_sampler(GT_MAPPING),
                         jax_samplers.make_ground_truth_action_sampler(GT_MAPPING)),
    }[sampler]
    evaluator = _port_evaluator(tiny_model, weights, config, port_sampler)
    batch = next(iter(evaluator.dataloader))
    model = evaluator.model.eval()
    before = _buffers(model)
    out = evaluator._forward(_nchw_sequence(batch.observations),
                             torch.from_numpy(batch.actions), torch.Generator())
    jax_evaluator.set_action_sampler(jax_sampler)
    NOISE.reset()
    want = jax_evaluator._forward(weights[0], jnp.asarray(batch.observations),
                                  jnp.asarray(batch.actions), jax.random.PRNGKey(0),
                                  batch.observations.shape[1])
    for name, value in vars(out).items():
        expected = getattr(want, name)
        if value is None:
            assert expected is None, name
            continue
        values, expecteds = ((value, expected) if isinstance(value, list)
                             else ([value], [expected]))
        for v, e in zip(values, expecteds):
            np.testing.assert_allclose(v.numpy(), to_port_layout(name, e), err_msg=name, **TOL)
    if sampler == "ground_truth":
        mapped = np.vectorize(GT_MAPPING.get)(batch.actions[:, :-1])
        np.testing.assert_array_equal(out.selected_actions.numpy(), mapped)
    for key, value in _buffers(model).items():
        assert torch.equal(value, before[key]), key


def test_evaluate_matches_jax(tiny_model, weights, config, jax_evaluator):
    """``Evaluator.evaluate`` with the one-hot sampler: the same metric keys,
    every metric within rtol 1e-3, the same accuracy and mapping, example
    images within one level; the model's mode is restored, its statistics
    and centroids untouched."""
    evaluator = _port_evaluator(tiny_model, weights, config, samplers.one_hot_action_sampler)
    evaluator.set_action_sampler(samplers.one_hot_action_sampler, label="one_hot")
    model = evaluator.model.train()
    before = _buffers(model)
    got = evaluator.evaluate(EVAL_STEP)
    assert model.training and all(m.training for m in model.modules())
    for key, value in _buffers(model).items():
        assert torch.equal(value, before[key]), key

    jax_evaluator.set_action_sampler(jax_samplers.one_hot_action_sampler, label="one_hot")
    NOISE.reset()
    want = jax_evaluator.evaluate(weights[0], EVAL_STEP)
    assert sorted(got) == sorted(want)
    assert len(got) == 1 + 8 + 3 * 6
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)
    assert got["validation/one_hot/actions_accuracy"] == want["validation/one_hot/actions_accuracy"]
    assert got["validation/one_hot/samples_entropy"] < 1e-5
    assert evaluator.get_best_action_mappings() == jax_evaluator.get_best_action_mappings()

    name = f"validation_observations_{EVAL_STEP}.png"
    got_image = read_frame(os.path.join(config["logging"]["output_images_directory"], name))
    want_image = read_frame(os.path.join(
        jax_evaluator.config["logging"]["output_images_directory"], name))
    assert got_image.shape == want_image.shape == (2 * 5 * 32, 6 * 32, 3)
    assert np.abs(got_image.astype(int) - want_image.astype(int)).max() <= 1

    model.eval()
    evaluator.evaluate(EVAL_STEP, save_images=False)
    assert not any(m.training for m in model.modules())
