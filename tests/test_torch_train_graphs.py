"""The port's captured training step and evaluation batch on the CPU.

The trainer's step (``graphs.TrainProgram``) and the evaluator's batch
(``graphs.Program``) run through the capture stand-in (``graphs.StandIn``),
which calls the captured callable on the same static buffers where a CUDA
graph would replay, on a tiny model (32x32 frames, 8 features, hidden 8,
stacking 2) with seeded weights and data.  Against the eager port they must
agree bit for bit: the same operations on the same values.  Against the
JAX package's train step the tolerances are ``tests/test_torch_train.py``'s
(losses rtol 1e-3 / atol 2e-4, the first step's gradient norms rtol 2e-3,
the BatchNorm statistics, centroids and MI matrix rtol 1e-3 / atol 2e-4),
with the noise drawn from one numpy source there.
"""
import gc
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    NOISE, patched_noise, random_variables, single_threaded_torch)

from playablevideogeneration_tpu.config.configuration import Configuration as JaxConfiguration
from playablevideogeneration_tpu.data.synthetic import make_synthetic_config as jax_config_of
from playablevideogeneration_tpu.models import vgg as jax_vgg
from playablevideogeneration_tpu.training import losses as jax_losses
from playablevideogeneration_tpu.training import trainer as jax_trainer
from playablevideogeneration_tpu.training.bench_harness import NullDataset
from playablevideogeneration_tpu.training.train_state import TrainState as JaxTrainState
from playablevideogeneration_tpu.utils.logging import Logger as JaxLogger
from playablevideogeneration_tpu_torch.cli import train as train_cli
from playablevideogeneration_tpu_torch.config.configuration import Configuration
from playablevideogeneration_tpu_torch.data.synthetic import make_synthetic_config
from playablevideogeneration_tpu_torch.data.transforms import make_train_transform
from playablevideogeneration_tpu_torch.data.video import read_frame
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset
from playablevideogeneration_tpu_torch.evaluation import action_sampler as samplers
from playablevideogeneration_tpu_torch.evaluation.builder import EvaluationDatasetBuilder
from playablevideogeneration_tpu_torch.evaluation import evaluator as evaluator_module
from playablevideogeneration_tpu_torch.evaluation.evaluator import Evaluator, eval_mode
from playablevideogeneration_tpu_torch.inference import graphs
from playablevideogeneration_tpu_torch.inference.play_session import PlaySession
from playablevideogeneration_tpu_torch.models.caddy import Caddy, make_model
from playablevideogeneration_tpu_torch.models.vgg import Vgg19
from playablevideogeneration_tpu_torch.ops.cuda import convlstm_gates
from playablevideogeneration_tpu_torch.ops.cuda.convlstm_gates import (
    fused_lstm_gates,
    fused_lstm_gates_bwd,
)
from playablevideogeneration_tpu_torch.tools import profile_step
from playablevideogeneration_tpu_torch.training import bench_harness
from playablevideogeneration_tpu_torch.training.trainer import Trainer, _histogram
from playablevideogeneration_tpu_torch.utils.jax_weights import (
    _convert,
    _leaves,
    load_jax_variables,
)
from playablevideogeneration_tpu_torch.utils.logging import Logger

TOL = dict(rtol=1e-3, atol=2e-4)
B = 2
PRETRAINING_STEPS = 2
# (sequence length, save a checkpoint after the step, load it after the
# step): two pretraining steps, then full-phase steps with the Gumbel
# temperature annealed at every step (1.0 -> 0.4 over 10 steps), the
# ground-truth frames falling from 3 to 2, the checkpoint of step 3 loaded
# after step 4, and the annealed length growing from 4 to 5 frames.
SCHEDULE = [(4, False, False), (4, False, False), (4, True, False), (4, False, True),
            (4, False, False), (5, False, False), (5, False, False)]


def _config(root: str) -> dict:
    config = bench_harness.make_synthetic_config(
        height=32, width=32, actions_count=3, batch_size=B, observations_count=4,
        observation_stacking=2, hidden_state_size=8, state_features=8,
        pretraining_steps=PRETRAINING_STEPS, remat=True)
    config["logging"]["save_root_directory"] = root
    config["training"]["gumbel_temperature_steps"] = 10  # a new value at every step
    return config


def _batch(length: int, seed: int):
    return bench_harness.make_synthetic_batch(
        batch_size=B, observations_count=length, height=32, width=32, actions_count=3,
        observation_stacking=2, seed=seed)


def _trainer(config: dict, backend=None) -> Trainer:
    trainer = Trainer(config, make_model(config, "cpu", seed=3), smooth_mi=True, seed=4,
                      backend=backend)
    trainer.init_state()
    return trainer


def _state(trainer: Trainer) -> dict:
    """Parameters, buffers, gradients, Adam's moments and the MI matrix."""
    state = trainer.state.state_dict()
    tensors = {f"model/{k}": v for k, v in state["model"].items()}
    tensors.update({f"grad/{k}": p.grad for k, p in trainer.model.named_parameters()})
    tensors.update({f"adam/{i}/{k}": v for i, slots in state["optimizer"]["state"].items()
                    for k, v in slots.items() if torch.is_tensor(v)})
    tensors["mi_matrix"] = state["mi_matrix"]
    return tensors


def _assert_same_state(got: Trainer, want: Trainer, step: int) -> None:
    got, want = _state(got), _state(want)
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(got[key], value), (step, key)


def _run_schedule(trainers, after_step) -> list:
    """Every trainer through SCHEDULE on the same batches, ``after_step``
    called after each step (before its checkpoint is saved or loaded);
    returns each step's metrics per trainer."""
    metrics = []
    for step, (length, save, load) in enumerate(SCHEDULE, start=1):
        batch = _batch(length, seed=step)
        metrics.append([trainer.train_step(batch) for trainer in trainers])
        after_step(step)
        for trainer in trainers:
            if save:
                trainer.save_checkpoint(f"step_{step}")
            if load:
                trainer.load_checkpoint(f"step_{step - 1}")
    return metrics


class _AloneStandIn(graphs.StandIn):
    """The stand-in that, when it warms up, checks that no program it
    warmed up before is alive: a new key's program is built after the old
    one and its memory pool are gone."""

    programs = []

    def warm_up(self, call, times):
        gc.collect()
        assert all(p() is None for p in self.programs), "an older program is alive"
        super().warm_up(call, times)
        self.programs.append(weakref.ref(self))


def test_graphed_trainer_matches_eager(tmp_path):
    """Every step's metrics and the whole state after it bit for bit: the
    switch from pretraining to the full phase, a temperature that changes at
    every step, the smooth-MI matrix, a checkpoint loaded midway and a
    longer annealed sequence; one capture per key and one after the load,
    never two live programs, not even while one is captured."""
    eager = _trainer(_config(str(tmp_path / "eager")))
    _AloneStandIn.programs = []
    graphed = _trainer(_config(str(tmp_path / "graphed")), _AloneStandIn)
    captures, programs = [], []

    def after_step(step):
        _assert_same_state(graphed, eager, step)
        captures.append(graphed.captures)
        programs.append(weakref.ref(graphed._program))
        gc.collect()
        assert {id(p()) for p in programs if p() is not None} == {id(graphed._program)}, step

    metrics = _run_schedule([eager, graphed], after_step)
    for step, (want, got) in enumerate(metrics, start=1):
        assert got.keys() == want.keys()
        assert all(got[k] == want[k] for k in want), step
    assert [m[0]["pretraining"] for m in metrics] == [1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    # Step 4 is taken twice: before and after the checkpoint of step 3 is loaded.
    temperatures = [m[0]["gumbel_temperature"] for m in metrics]
    assert len(set(temperatures)) == 6 and temperatures[3] == temperatures[4]
    assert [m[0]["ground_truth_observations"] for m in metrics] == [3, 3, 3, 2, 2, 2, 2]
    # Keys: (4 frames, pretraining, 3), (4, full, 3), (4, full, 2), the same
    # again after the load, then (5, full, 2).
    assert captures == [1, 1, 2, 3, 4, 5, 5]
    assert eager.captures == 0 and eager._program is None
    assert len(_AloneStandIn.programs) == 5
    assert graphed.global_step == eager.global_step == len(SCHEDULE) - 1


def _counting(monkeypatch):
    """The plain versions counted as the kernels count: K1 where the
    forward computes the gate update, K2 where its backward runs."""
    forward, backward = convlstm_gates._forward, convlstm_gates._FusedGates.backward

    def gates(g, c):
        fused_lstm_gates.launches += 1
        return forward(g, c)

    def gates_bwd(ctx, dh, dc):
        fused_lstm_gates_bwd.launches += 1
        return backward(ctx, dh, dc)

    monkeypatch.setattr(convlstm_gates, "_forward", gates)
    monkeypatch.setattr(convlstm_gates._FusedGates, "backward", staticmethod(gates_bwd))


def test_replays_count_launches_as_eager_steps(tmp_path, monkeypatch):
    """K1 and K2 per step as the eager step counts them, the warm-up's
    launches left out: with per-step checkpointing K1 runs twice per
    ConvLSTM and dynamics step (forward and recompute), K2 once."""
    _counting(monkeypatch)
    counts = []
    for backend in (None, graphs.StandIn):
        trainer = _trainer(_config(str(tmp_path / str(backend))), backend)
        per_step = []
        for step, (length, _, _) in enumerate(SCHEDULE[:4], start=1):
            before = fused_lstm_gates.launches, fused_lstm_gates_bwd.launches
            trainer.train_step(_batch(length, seed=step))
            per_step.append((fused_lstm_gates.launches - before[0],
                             fused_lstm_gates_bwd.launches - before[1]))
        counts.append(per_step)
    assert counts[0] == counts[1] == [(6 * 3, 3 * 3)] * 4


class _Recording(graphs.StandIn):
    """The stand-in that notes the model's buffers, the generator and the
    gradients right after its warm-up and where the capture starts."""

    trainer = None
    notes = []

    def _note(self, when):
        trainer = self.trainer
        self.notes.append((when, {k: v.clone() for k, v in trainer.model.named_buffers()},
                           trainer.state.mi_matrix.clone(), trainer.generator.get_state(),
                           [p.grad for p in trainer.model.parameters()]))

    def warm_up(self, call, times):
        super().warm_up(call, times)
        self._note("warmed")

    def capture(self, run, generators):
        self._note("capture")
        super().capture(run, generators)


def test_warm_up_leaves_no_trace(tmp_path):
    """The warm-up folds the BatchNorm statistics and the centroids and
    draws noise; by the capture, every buffer, the MI matrix and the
    generator are as they were before the step, and no gradient is left."""
    trainer = _trainer(_config(str(tmp_path)), _Recording)
    _Recording.trainer, _Recording.notes = trainer, []
    before = ({k: v.clone() for k, v in trainer.model.named_buffers()},
              trainer.state.mi_matrix.clone(), trainer.generator.get_state())
    trainer.train_step(_batch(4, seed=1))
    (_, warmed, _, warmed_generator, _), (_, buffers, mi, generator, grads) = _Recording.notes
    assert not torch.equal(warmed_generator, before[2])
    moved = [k for k in buffers if not torch.equal(warmed[k], before[0][k])]
    assert any("running_mean" in k for k in moved) and "centroids" in moved
    for key, value in before[0].items():
        assert torch.equal(buffers[key], value), key
    assert torch.equal(mi, before[1]) and torch.equal(generator, before[2])
    assert all(g is None for g in grads)


def test_replay_advances_the_buffers_versions(tmp_path):
    """A CUDA graph's replay writes the statistics and centroids without
    advancing their version counters; the program advances them, so a
    captured evaluation of the model sees that they moved."""
    trainer = _trainer(_config(str(tmp_path)), graphs.StandIn)
    trainer.train_step(_batch(4, seed=1))
    program = trainer._program
    versions = [b._version for b in trainer.model.buffers()]
    program._replayed()
    assert all(b._version > v for b, v in zip(trainer.model.buffers(), versions))


def test_the_static_gradients_stay_put(tmp_path):
    """The parameters' ``.grad`` are the program's static gradients after
    every step, the same tensors from step to step."""
    trainer = _trainer(_config(str(tmp_path)), graphs.StandIn)
    trainer.train_step(_batch(4, seed=1))
    grads = [p.grad for p in trainer.model.parameters()]
    trainer.train_step(_batch(4, seed=2))
    assert all(p.grad is g for p, g in zip(trainer.model.parameters(), grads))
    static = graphs.leaves(trainer._program._backend.outputs["grads"])
    assert len(static) == len(grads) and all(g is s for g, s in zip(grads, static))
    trainer.drop_program()
    assert all(p.grad is None for p in trainer.model.parameters())


def test_a_dropped_owner_frees_its_programs(tmp_path, eval_setup):
    """A program holds its owner weakly: dropping a trainer, an evaluator,
    a play session or a builder frees it, and with it its graphs and their
    memory pools, without waiting for the cycle collector."""
    trainer = _trainer(_config(str(tmp_path)), graphs.StandIn)
    trainer.train_step(_batch(4, seed=1))
    evaluator = _evaluator(eval_setup, "dropped", graphs.StandIn)
    evaluator.evaluate(7, save_images=False)
    config, model, dataset, _ = eval_setup
    session = PlaySession(model, backend=graphs.StandIn).start(
        np.zeros((32, 32, 6), np.float32))
    builder = EvaluationDatasetBuilder(config, model, dataset, Logger(), backend=graphs.StandIn)
    with eval_mode(model):
        session.rollout(np.array([0, 1]))
        builder.reconstruct(next(iter(builder.dataloader)), builder.generator)
    assert trainer._program is not None and evaluator._programs
    assert session._programs and builder._programs
    owners = [weakref.ref(o) for o in (trainer, evaluator, session, builder)]
    gc.disable()
    try:
        del trainer, evaluator, session, builder
        assert [owner() for owner in owners] == [None] * 4
    finally:
        gc.enable()


def test_a_model_in_evaluation_mode_is_refused(tmp_path):
    trainer = _trainer(_config(str(tmp_path)), graphs.StandIn)
    trainer.model.eval()
    with pytest.raises(RuntimeError, match="training mode"):
        trainer.train_step(_batch(4, seed=1))


def test_grad_histograms_graphed_match_eager(tmp_path):
    config = _config(str(tmp_path))
    config["tpu"]["grad_histograms"] = True
    eager, graphed = _trainer(config), _trainer(config, graphs.StandIn)
    for step in (1, 2, 3):
        want, got = eager.train_step(_batch(4, seed=step)), graphed.train_step(_batch(4, step))
        hists = [k for k in want if k.startswith("_grad_hist/")]
        assert len(hists) == 5  # the five subnetworks; the centroids are a buffer
        for key in hists:
            np.testing.assert_array_equal(got[key][0], want[key][0])
            np.testing.assert_array_equal(got[key][1], want[key][1])


@pytest.mark.parametrize("kind", ["normal", "ties", "constant"])
def test_histogram_counts_are_numpys(kind):
    """The scatter of ones gives ``np.histogram``'s counts on the same
    edges (the last bin closed), as ``torch.bincount`` gave them."""
    rng = np.random.default_rng(7)
    values = {"normal": rng.normal(size=5000),
              "ties": rng.integers(-3, 4, 5000) * 0.25,
              "constant": np.full(100, 0.3)}[kind]
    values = torch.from_numpy(values.astype(np.float32))
    counts, edges = _histogram(values)
    assert counts.dtype == torch.int64 and counts.shape == (64,) and edges.shape == (65,)
    want, _ = np.histogram(values.numpy(), bins=edges.numpy())
    np.testing.assert_array_equal(counts.numpy(), want)
    index = (torch.searchsorted(edges, values, right=True) - 1).clamp(0, 63)
    np.testing.assert_array_equal(counts.numpy(), torch.bincount(index, minlength=64).numpy())
    assert int(counts.sum()) == values.numel()


def test_the_harness_and_the_profiler_pass_the_seam(monkeypatch, tmp_path):
    """The harness hands the seam to the trainer, and the step profiler,
    whose scopes are module hooks that a replay does not fire, asks for
    the op-by-op step."""
    trainer = bench_harness.build_synthetic_trainer(
        height=32, width=32, batch_size=B, observations_count=4, actions_count=3,
        observation_stacking=2, hidden_state_size=8, state_features=8, device="cpu",
        backend=graphs.StandIn)
    assert trainer._backend is graphs.StandIn
    assert graphs.resolve_backend(torch.device("cuda", 0), graphs.Eager) is None
    assert graphs.resolve_backend(torch.device("cuda", 0), None) is graphs.CudaGraph
    assert graphs.resolve_backend(torch.device("cpu"), None) is None

    class Built(Exception):
        pass

    def record(**kwargs):
        raise Built(kwargs)

    monkeypatch.setattr(bench_harness, "build_synthetic_trainer", record)
    with pytest.raises(Built) as built:
        profile_step.capture(batch=B, steps=1, height=32, width=32, t=4,
                             trace_dir=str(tmp_path), device="cpu")
    assert built.value.args[0]["backend"] is graphs.Eager


# --------------------------------------------------------------------- #
# Against the JAX package's train step                                  #
# --------------------------------------------------------------------- #


class _NoiseResetStandIn(graphs.StandIn):
    """The stand-in with the shared numpy noise reset before each replay, as
    each JAX step starts from it."""

    def replay(self):
        NOISE.reset()
        super().replay()


def _jax_train_config():
    config = jax_config_of(
        data_root="/nonexistent", output_root="/nonexistent", height=32, width=32,
        actions_count=3, batch_size=B, observations_count=4, observation_stacking=2,
        hidden_state_size=8, state_features=8, pretraining_steps=0)
    JaxConfiguration(config=config).check_config(check_data_root=False)
    return config


def test_graphed_steps_match_the_jax_train_step(tiny_model, tiny_variables):
    """Three graphed full-phase steps of the port's trainer (smooth MI) and
    the JAX trainer's jitted step from the same weights, batch and noise:
    each step's loss, the first step's gradient norms, and the BatchNorm
    statistics, centroids and MI matrix after it."""
    variables = random_variables(tiny_variables, seed=11)
    vgg_variables = random_variables(
        jax.eval_shape(jax_vgg.random_vgg_variables, jax.random.PRNGKey(0)), seed=12)
    config = _jax_train_config()
    jax_tr = jax_trainer.Trainer(config, tiny_model, NullDataset(), JaxLogger(),
                                 smooth_mi=True, vgg_variables=vgg_variables)
    step_fn = jax_tr._make_train_step(False)
    state = JaxTrainState(params=variables["params"],
                          opt_state=jax_tr.tx.init(variables["params"]),
                          batch_stats=variables["batch_stats"],
                          model_state=variables["model_state"],
                          mi_matrix=jax_losses.init_mi_matrix(3), step=jnp.zeros((), jnp.int32))
    model = load_jax_variables(
        Caddy(tiny_model.actions_count, tiny_model.action_space_dimension,
              tiny_model.state_features, tiny_model.state_resolution,
              tiny_model.hidden_state_size, tiny_model.observation_stacking),
        variables).train()
    port = Trainer(config, model, smooth_mi=True,
                   vgg=load_jax_variables(Vgg19(), vgg_variables), backend=_NoiseResetStandIn)
    port.init_state()
    rng = np.random.default_rng(5)
    obs = rng.uniform(-1, 1, (B, 4, 32, 32, 6)).astype(np.float32)
    acts = rng.integers(0, 3, (B, 4)).astype(np.int32)
    with patched_noise():
        for step in range(3):
            got = port.train_step(type("Batch", (), dict(observations=obs, actions=acts)))
            NOISE.reset()
            state, want = step_fn(state, jnp.asarray(obs), jnp.asarray(acts),
                                  jnp.asarray(got["ground_truth_observations"], jnp.int32),
                                  jnp.asarray(got["gumbel_temperature"], jnp.float32),
                                  jax.random.PRNGKey(0), jax_tr.vgg_variables)
            want = jax.device_get(want)
            np.testing.assert_allclose(got["loss"], want["loss"], err_msg=str(step), **TOL)
            if step:
                continue
            norms = [k for k in want if k.startswith("grad_norm/")]
            assert len(norms) == 6
            for key in norms:
                np.testing.assert_allclose(got[key], want[key], rtol=2e-3, err_msg=key)
            buffers = dict(port.model.named_buffers())
            for collection in ("batch_stats", "model_state"):
                for path, value in _leaves(jax.device_get(getattr(state, collection))):
                    key, value = _convert(collection, path, value)
                    np.testing.assert_allclose(buffers[key].numpy(), value, err_msg=key, **TOL)
            np.testing.assert_allclose(port.state.mi_matrix.numpy(),
                                       np.asarray(state.mi_matrix), **TOL)
    assert port.captures == 1


# --------------------------------------------------------------------- #
# The evaluator                                                         #
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def eval_setup(synthetic_dataset_dir, tmp_path_factory):
    """(config, model, validation split, VGG19) over the conftest synthetic
    data."""
    config = make_synthetic_config(
        data_root=synthetic_dataset_dir, output_root=str(tmp_path_factory.mktemp("eval_graphs")),
        height=32, width=32, actions_count=3, observation_stacking=2, hidden_state_size=8,
        state_features=8)
    Configuration(config=config).check_config()
    dataset = VideoDataset(os.path.join(synthetic_dataset_dir, "val"),
                           config["evaluation"]["batching"], make_train_transform(None, (32, 32)))
    torch.manual_seed(33)
    return config, make_model(config, "cpu", seed=31), dataset, Vgg19().eval()


def _evaluator(setup, prefix: str, backend=None) -> Evaluator:
    config, model, dataset, vgg = setup
    return Evaluator(config, model, dataset, Logger(), logger_prefix=prefix, vgg=vgg,
                     backend=backend)


SAMPLERS = {"gumbel": lambda: None, "one_hot": lambda: samplers.one_hot_action_sampler,
            "ground_truth": lambda: samplers.make_ground_truth_action_sampler({0: 2, 1: 0, 2: 1})}


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_graphed_evaluator_matches_eager(eval_setup, sampler):
    """Two rounds (the generator reseeded in place) bit for bit: every
    metric, the accuracy, the mapping and the example image, whose batch's
    outputs the later batches' replays must not overwrite; one program per
    (sampler, B, T), the model's mode and buffers restored."""
    config, model, _, _ = eval_setup
    action_sampler = SAMPLERS[sampler]()
    eager = _evaluator(eval_setup, sampler)
    graphed = _evaluator(eval_setup, sampler, graphs.StandIn)
    for evaluator in (eager, graphed):
        evaluator.set_action_sampler(action_sampler, label=sampler)
    model.train()
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    image = os.path.join(config["logging"]["output_images_directory"],
                         f"{sampler}_observations_{{}}.png")
    for step in (3, 4):
        want = eager.evaluate(step)
        want_image = read_frame(image.format(step))
        got = graphed.evaluate(step)
        assert got.keys() == want.keys() and len(got) == 1 + 8 + 3 * 6
        assert all(got[k] == want[k] for k in want), step
        assert graphed.get_best_action_mappings() == eager.get_best_action_mappings()
        np.testing.assert_array_equal(read_frame(image.format(step)), want_image)
    assert model.training
    assert all(torch.equal(v, buffers[k]) for k, v in model.named_buffers())
    assert {key[1:]: p.captures for key, p in graphed._programs.items()} == {(2, 6): 1}
    assert eager._programs == {}


def test_the_program_cache_evicts_the_least_recently_used(eval_setup):
    """Seven samplers make seven keys; the cache keeps six, the least
    recently used going first, and a hit neither captures nor evicts."""
    evaluator = _evaluator(eval_setup, "lru", graphs.StandIn)
    batch = next(iter(evaluator.dataloader))
    observations = torch.from_numpy(np.ascontiguousarray(
        batch.observations.transpose(0, 1, 4, 2, 3)))
    actions = torch.from_numpy(batch.actions)
    keys = [samplers.make_ground_truth_action_sampler({0: i % 3, 1: 1, 2: 2})
            for i in range(evaluator_module.PROGRAMS + 1)]
    with eval_mode(evaluator.model):
        for i, sampler in enumerate(keys):
            evaluator.set_action_sampler(sampler)
            evaluator._batch(observations, actions)
            if i == 1:  # keys[0] used again: keys[1] is now the oldest
                evaluator.set_action_sampler(keys[0])
                evaluator._batch(observations, actions)
        assert [key[0] for key in evaluator._programs] == [keys[0]] + keys[2:]
        assert all(p.captures == 1 for p in evaluator._programs.values())


def test_a_new_model_is_captured_anew(eval_setup):
    """``Trainer.full_model_in`` hands the evaluator another model (a
    full-width copy under tensor parallelism): its batch is captured for
    that model."""
    config = eval_setup[0]
    evaluator = _evaluator(eval_setup, "swap", graphs.StandIn)
    evaluator.evaluate(5, save_images=False)
    program = next(iter(evaluator._programs.values()))
    evaluator.model = make_model(config, "cpu", seed=32)
    evaluator.evaluate(5, save_images=False)
    assert next(iter(evaluator._programs.values())) is not program
    assert next(iter(evaluator._programs.values())).model is evaluator.model


def test_the_ground_truth_sampler_table_lies_on_the_models_device():
    mapping = {0: 2, 1: 0, 2: 1}
    assert samplers.make_ground_truth_action_sampler(mapping).table.device.type == "cpu"
    meta = torch.device("meta")
    assert samplers.make_ground_truth_action_sampler(mapping, meta).table.device == meta

    class Validation:
        device = meta

        def __init__(self):
            self.samplers = []

        def set_action_sampler(self, sampler, label=None):
            self.samplers.append((label, sampler))

        def evaluate(self, step, save_images=True):
            return {}

        def get_best_action_mappings(self):
            return mapping

    validation = Validation()
    train_cli.evaluate(validation, 3, ground_truth_available=True)
    label, sampler = validation.samplers[-1]
    assert label == "gt_actions" and sampler.table.device == meta


def test_an_evaluation_after_a_graphed_step_captures_again(tmp_path, eval_setup):
    """A captured evaluation of the trained model captures again after a
    replay of the train step, whose writes to the statistics and centroids
    only the version bump makes visible (the optimizer is left out here),
    and then reads the new statistics: it equals a fresh capture."""
    trainer = _trainer(_config(str(tmp_path)), graphs.StandIn)
    trainer.train_step(_batch(4, seed=1))
    config, _, dataset, vgg = eval_setup
    evaluator = Evaluator(config, trainer.model, dataset, Logger(), logger_prefix="after",
                          vgg=vgg, backend=graphs.StandIn)
    evaluator.evaluate(6, save_images=False)
    program = next(iter(evaluator._programs.values()))
    with torch.no_grad():
        for buffer in trainer.model.buffers():
            buffer.data.mul_(0.5)  # a write that leaves the version counter as it is
    trainer._program._replayed()
    got = evaluator.evaluate(6, save_images=False)
    assert program.captures == 2
    fresh = Evaluator(config, trainer.model, dataset, Logger(), logger_prefix="after",
                      vgg=evaluator.vgg, backend=graphs.StandIn)
    want = fresh.evaluate(6, save_images=False)
    assert all(got[k] == want[k] for k in want)
