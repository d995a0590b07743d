"""The port's captured routes (``inference.graphs``) on the CPU.

The play session and the evaluation-dataset builder run their programs
through the capture stand-in (``graphs.StandIn``), which calls the
captured callable on the same static buffers where a CUDA graph would
replay, on the conftest tiny model with seeded weights.  Against the eager
port they must agree bit for bit: the same operations on the same values.
Against the JAX package the tolerances are those of
``tests/test_torch_play.py`` (frames rtol 1e-3 / atol 2e-4 in f32, uint8
frames within one level) and ``tests/test_torch_offline_eval.py`` (uint8
frames within one level, inferred actions exact, encoded actions rtol
1e-3 / atol 2e-4), the noise drawn from one numpy source there.
"""
import copy
import os

import jax
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    NOISE, patched_noise, random_variables, single_threaded_torch)

from playablevideogeneration_tpu.data import transforms as jax_transforms
from playablevideogeneration_tpu.data.video import Video as JaxVideo
from playablevideogeneration_tpu.data.video_dataset import VideoDataset as JaxVideoDataset
from playablevideogeneration_tpu.evaluation.builder import (
    EvaluationDatasetBuilder as JaxBuilder,
)
from playablevideogeneration_tpu.inference.play_session import PlaySession as JaxPlaySession
from playablevideogeneration_tpu.utils.logging import Logger as JaxLogger
from playablevideogeneration_tpu_torch.config.configuration import Configuration
from playablevideogeneration_tpu_torch.data.synthetic import make_synthetic_config
from playablevideogeneration_tpu_torch.data.transforms import make_train_transform
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset
from playablevideogeneration_tpu_torch.evaluation.builder import EvaluationDatasetBuilder
from playablevideogeneration_tpu_torch.inference import graphs
from playablevideogeneration_tpu_torch.inference.play_session import PlaySession
from playablevideogeneration_tpu_torch.models import layers
from playablevideogeneration_tpu_torch.models.caddy import Caddy
from playablevideogeneration_tpu_torch.ops.cuda.convlstm_gates import fused_lstm_gates
from playablevideogeneration_tpu_torch.ops.cuda.fused_norm_act import (
    fused_batch_norm_leaky_relu,
)
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables
from playablevideogeneration_tpu_torch.utils.logging import Logger

TOL = dict(rtol=1e-3, atol=2e-4)
BUILDER_BATCH = 4  # 22 test sequences: five full batches and a ragged one of 2
ROLLOUT = np.array([0, 1, 2, 1])


def _port_of(jax_model) -> Caddy:
    return Caddy(jax_model.actions_count, jax_model.action_space_dimension,
                 jax_model.state_features, jax_model.state_resolution,
                 jax_model.hidden_state_size, jax_model.observation_stacking).eval()


@pytest.fixture(scope="module")
def tiny_pair(tiny_model, tiny_variables):
    """(JAX variables, port model) with the same seeded weights."""
    variables = random_variables(tiny_variables, seed=3)
    return variables, load_jax_variables(_port_of(tiny_model), variables)


def _window(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (32, 32, 6)).astype(np.float32)


def _play(session, obs: np.ndarray) -> list:
    """start, three steps, a uint8 step, two interpolation steps and a
    rollout of four actions: what each returns."""
    session.start(obs)
    out = [session.generate_next(a) for a in (0, 2, 1)]
    out.append(session.generate_next_u8(1))
    out += [session.generate_next_interpolation(0, 2, f) for f in (0.3, 0.8)]
    out.append(session.rollout(ROLLOUT))
    return out


def _captures(session) -> dict:
    return {key: program.captures for key, program in session._programs.items()}


@pytest.mark.parametrize("noise", [False, True])
def test_graphed_session_matches_eager(tiny_pair, noise):
    _, port = tiny_pair
    obs = _window(2)
    want = _play(PlaySession(port, noise=noise, seed=4), obs)
    session = PlaySession(port, noise=noise, seed=4, backend=graphs.StandIn)
    got = _play(session, obs)
    assert [g.dtype for g in got] == [np.float32] * 3 + [np.uint8] + [np.float32] * 2 + [
        np.uint8]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert _captures(session) == {"step": 1, ("rollout", 4): 1}


def test_graphed_session_matches_jax(tiny_model, tiny_pair):
    variables, port = tiny_pair
    obs = _window(2)
    got = _play(PlaySession(port, backend=graphs.StandIn), obs)
    want = _play(JaxPlaySession(tiny_model, variables), obs)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == np.uint8:
            assert g.dtype == np.uint8 and g.shape == w.shape
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(g, w, **TOL)


def test_block_false_frame_is_not_overwritten(tiny_pair):
    _, port = tiny_pair
    session = PlaySession(port, backend=graphs.StandIn).start(_window(3))
    frame = session.generate_next_u8(1, block=False)
    kept = frame.clone()
    session.generate_next_u8(2, block=False)
    session.generate_next(0)
    assert torch.equal(frame, kept)
    static = graphs.leaves(session._programs["step"]._backend.outputs)
    assert all(frame.data_ptr() != t.data_ptr() for t in static)


def test_two_sessions_on_one_model_keep_their_own_state(tiny_pair):
    _, port = tiny_pair
    graphed = [PlaySession(port, backend=graphs.StandIn).start(_window(s)) for s in (4, 5)]
    eager = [PlaySession(port).start(_window(s)) for s in (4, 5)]
    for action in (0, 1, 2, 2):
        for g, e in zip(graphed, eager):
            np.testing.assert_array_equal(g.generate_next(action), e.generate_next(action))
    for g, e in zip(graphed, eager):
        np.testing.assert_array_equal(g.rollout(ROLLOUT), e.rollout(ROLLOUT))
    assert graphed[0].window.data_ptr() != graphed[1].window.data_ptr()


def test_restart_equals_a_fresh_session(tiny_pair):
    _, port = tiny_pair
    session = PlaySession(port, noise=True, seed=6, backend=graphs.StandIn)
    _play(session, _window(6))
    state = [t.data_ptr() for t in session._state()]
    session._generator.manual_seed(6)
    again = _play(session, _window(7))
    fresh = _play(PlaySession(port, noise=True, seed=6, backend=graphs.StandIn), _window(7))
    eager = _play(PlaySession(port, noise=True, seed=6), _window(7))
    for a, f, e in zip(again, fresh, eager):
        np.testing.assert_array_equal(a, f)
        np.testing.assert_array_equal(a, e)
    assert [t.data_ptr() for t in session._state()] == state
    assert _captures(session) == {"step": 1, ("rollout", 4): 1}


def test_weight_load_between_steps_is_seen(tiny_pair, tiny_variables):
    variables, port = tiny_pair
    graphed_model, eager_model = copy.deepcopy(port), copy.deepcopy(port)
    graphed = PlaySession(graphed_model, backend=graphs.StandIn).start(_window(8))
    eager = PlaySession(eager_model).start(_window(8))
    for action in (0, 1):
        np.testing.assert_array_equal(graphed.generate_next(action), eager.generate_next(action))
    other = random_variables(tiny_variables, seed=9)
    for model in (graphed_model, eager_model):
        load_jax_variables(model, other)  # copies into the parameters in place
    got, want = graphed.generate_next(2), eager.generate_next(2)
    np.testing.assert_array_equal(got, want)
    assert _captures(graphed) == {"step": 2}
    # The new weights, not the old ones, made the frame.
    old = PlaySession(port).start(_window(8))
    old_frames = [old.generate_next(a) for a in (0, 1, 2)]
    assert not np.array_equal(got, old_frames[-1])


def test_replays_count_launches_as_eager_calls(tiny_pair, monkeypatch):
    """The plain versions counted as the kernels count: a graphed session's
    calls move the counters exactly as the eager session's do."""
    _, port = tiny_pair

    def counting(wrapper):
        def call(*args, **kwargs):
            wrapper.launches += 1
            return wrapper(*args, **kwargs)
        return call

    monkeypatch.setattr(layers, "fused_lstm_gates", counting(fused_lstm_gates))
    monkeypatch.setattr(layers, "fused_batch_norm_leaky_relu",
                        counting(fused_batch_norm_leaky_relu))
    counts = []
    for backend in (None, graphs.StandIn):
        before = fused_lstm_gates.launches, fused_batch_norm_leaky_relu.launches
        _play(PlaySession(port, backend=backend), _window(10))
        counts.append((fused_lstm_gates.launches - before[0],
                       fused_batch_norm_leaky_relu.launches - before[1]))
    steps = 3 + 1 + 2 + len(ROLLOUT)
    assert counts[0] == counts[1] == (3 * steps, 15 * steps)


def test_a_model_in_training_mode_is_refused(tiny_pair):
    _, port = tiny_pair
    model = copy.deepcopy(port).train()
    with pytest.raises(RuntimeError, match="evaluation mode"):
        PlaySession(model, backend=graphs.StandIn).start(_window(11)).generate_next(0)


def test_program_keeps_static_buffers_generators_and_counters():
    """A program's state is written in place, its outputs are the same
    tensors at every call, its warm-up leaves the generator where it was,
    and its capture leaves the launch counters where they were."""
    generator = torch.Generator().manual_seed(12)
    model = torch.nn.Linear(2, 2).eval()

    def fn(state, x):
        fused_lstm_gates.launches += 1
        return [state + x + torch.randn(2, generator=generator)], (state * 2,)

    state, x = torch.zeros(2), torch.zeros(2)
    before = fused_lstm_gates.launches
    program = graphs.Program(fn, [state], [x], model, graphs.StandIn, generators=[generator])
    assert fused_lstm_gates.launches == before
    outputs = [program(torch.full((2,), float(i)))[0] for i in range(3)]
    assert fused_lstm_gates.launches == before + 3
    assert all(o is outputs[0] for o in outputs)

    eager_generator, want = torch.Generator().manual_seed(12), torch.zeros(2)
    for i in range(3):
        doubled = want * 2
        want = want + i + torch.randn(2, generator=eager_generator)
    assert torch.equal(state, want) and torch.equal(outputs[0], doubled)
    assert program.captures == 1


def test_backend_for_chooses_by_device():
    assert graphs.backend_for(torch.device("cpu")) is None
    assert graphs.backend_for(torch.device("cuda", 0)) is graphs.CudaGraph


# --------------------------------------------------------------------- #
# The evaluation-dataset builder                                        #
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def builder_setup(tiny_model, tiny_variables, synthetic_dataset_dir, tmp_path_factory):
    """(config, port model, test split, JAX variables) over the conftest
    synthetic test split, batches of 4."""
    config = make_synthetic_config(
        data_root=synthetic_dataset_dir,
        output_root=str(tmp_path_factory.mktemp("graphed_builder")), height=32, width=32,
        actions_count=3, observation_stacking=2, hidden_state_size=8, state_features=8)
    config["evaluation"]["batching"]["batch_size"] = BUILDER_BATCH
    Configuration(config=config).check_config()
    variables = random_variables(tiny_variables, seed=61)
    model = load_jax_variables(_port_of(tiny_model), variables)
    dataset = VideoDataset(os.path.join(synthetic_dataset_dir, "test"),
                           config["evaluation"]["batching"], make_train_transform(None, (32, 32)))
    return config, model, dataset, variables


def _assert_same_videos(got, want):
    assert len(got) == len(want) == 22
    for g, w in zip(got, want):
        assert g.get_frames_count() == w.get_frames_count() == 6
        for i in range(6):
            np.testing.assert_array_equal(g.get_frame_at(i), w.get_frame_at(i))
        assert g.metadata == w.metadata
        assert g.actions == w.actions and g.dones == w.dones


def test_graphed_builder_matches_eager(builder_setup):
    """Frames and metadata (inferred and encoded actions) bit for bit, one
    program per batch shape, the ragged last batch's its own, reused by a
    second build; the model's mode restored."""
    config, model, dataset, _ = builder_setup
    model.train()
    want = EvaluationDatasetBuilder(config, model, dataset, Logger()).build_videos()
    builder = EvaluationDatasetBuilder(config, model, dataset, Logger(), backend=graphs.StandIn)
    first = builder.build_videos()
    again = builder.build_videos()
    assert model.training
    model.eval()
    _assert_same_videos(first, want)
    _assert_same_videos(again, want)
    assert {key: p.captures for key, p in builder._programs.items()} == {(4, 6): 1, (2, 6): 1}


class _NoiseResetStandIn(graphs.StandIn):
    """The stand-in with the shared numpy noise reset before each replay,
    as the JAX builder's forward is reset before it traces."""

    def replay(self):
        NOISE.reset()
        super().replay()


def test_graphed_builder_matches_jax(tiny_model, builder_setup, tmp_path):
    config, model, dataset, variables = builder_setup
    jax_config = copy.deepcopy(config)
    jax_config["logging"]["evaluation_dataset_directory"] = str(tmp_path / "jax")
    jax_builder = JaxBuilder(jax_config, tiny_model, JaxVideoDataset(
        os.path.join(config["data"]["data_root"], "test"), config["evaluation"]["batching"],
        jax_transforms.make_train_transform(None, (32, 32))), JaxLogger())
    forward = jax_builder._forward

    def reset_then_forward(*args):
        NOISE.reset()
        return forward(*args)

    jax_builder._forward = reset_then_forward
    builder = EvaluationDatasetBuilder(config, model, dataset, Logger(),
                                       backend=_NoiseResetStandIn)
    with patched_noise():
        jax_path = jax_builder.build(jax.tree.map(np.asarray, variables))
        videos = builder.build_videos()
    names = sorted(os.listdir(jax_path))
    assert len(names) == len(videos) == 22
    for video, name in zip(videos, names):
        want = JaxVideo()
        want.load(os.path.join(jax_path, name))
        for i in range(6):
            assert np.abs(video.get_frame_at(i).astype(int) - np.asarray(
                want.get_frame_at(i)).astype(int)).max() <= 1
        assert video.metadata[-1] == want.metadata[-1] == {"model": "ours"}
        for got_meta, want_meta in zip(video.metadata[:-1], want.metadata[:-1]):
            assert got_meta["inferred_action"] == want_meta["inferred_action"]
            np.testing.assert_allclose(got_meta["encoded_action"], want_meta["encoded_action"],
                                       **TOL)
