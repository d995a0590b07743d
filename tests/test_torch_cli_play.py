"""Parity of the port's play and interpolate CLIs with the JAX package, on
the CPU.

The conftest tiny model's seeded variables reach both packages through a
reference ``.pth.tar`` (``chip_smoke.write_reference_checkpoint``, held to
the JAX importer by tests/test_torch_reference_checkpoint.py), and the
port also through its own ``latest`` checkpoint; the start sequence
and frame are drawn from the current time, pinned in both packages.
The JAX trainer's variable init is replaced by the conftest's cached
variables, which the import overwrites anyway, so that no JAX init is
compiled.  Frames: rtol 1e-3 / atol 2e-4 in f32 (the harness's
tolerance), uint8 frames within one level.
"""
import copy
import io
import itertools
import os
import pickle
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml
from torch_parity import random_variables, single_threaded_torch  # noqa: F401

import chip_smoke

from playablevideogeneration_tpu.cli import interpolate as jax_interpolate
from playablevideogeneration_tpu.cli import play as jax_play
from playablevideogeneration_tpu.config.configuration import Configuration as JaxConfiguration
from playablevideogeneration_tpu.data.synthetic import make_synthetic_config
from playablevideogeneration_tpu.training import trainer as jax_trainer
from playablevideogeneration_tpu.utils.input_helper import InputHelper as JaxInputHelper
from playablevideogeneration_tpu_torch.cli import build_evaluation_dataset as build_cli
from playablevideogeneration_tpu_torch.cli import evaluate_dataset as evaluate_cli
from playablevideogeneration_tpu_torch.cli import interpolate, play
from playablevideogeneration_tpu_torch.data.video import read_frame
from playablevideogeneration_tpu_torch.models.caddy import make_model
from playablevideogeneration_tpu_torch.training.trainer import Trainer
from playablevideogeneration_tpu_torch.utils.input_helper import InputHelper
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables
from playablevideogeneration_tpu_torch.utils.logging import Logger

TOL = dict(rtol=1e-3, atol=2e-4)
PINNED_TIME = 1_700_000_123.25
ROLLOUT_FRAMES = 5


@pytest.fixture(scope="module")
def variables(tiny_variables):
    return random_variables(tiny_variables, seed=41)


@pytest.fixture(scope="module")
def setup(tmp_path_factory, synthetic_dataset_dir, variables):
    """(config factory, reference checkpoint path): each checked config
    (the JAX package's ``check_config``, which derives the port's paths)
    has its own output root, all share one save root that holds the
    port's ``latest`` checkpoint of the same weights."""
    root = tmp_path_factory.mktemp("cli_play")

    def make(name):
        config = make_synthetic_config(data_root=synthetic_dataset_dir,
                                       output_root=str(root / name), height=32, width=32,
                                       actions_count=3, observation_stacking=2,
                                       hidden_state_size=8, state_features=8)
        config["logging"]["save_root"] = str(root / "checkpoints")
        JaxConfiguration(config=config).check_config()
        JaxConfiguration(config=config).create_directory_structure()
        return config

    config = make("port_checkpoint")
    trainer = Trainer(config, load_jax_variables(make_model(config, "cpu"), variables))
    checkpoint = str(root / "reference.pth.tar")
    chip_smoke.write_reference_checkpoint(trainer.model, checkpoint)
    trainer.init_state()
    trainer.save_checkpoint()
    return make, checkpoint


@pytest.fixture
def pinned(monkeypatch, tiny_variables):
    """``time.time`` pinned, and the JAX trainer's init given the cached
    variables instead of compiling one."""
    monkeypatch.setattr(time, "time", lambda: PINNED_TIME)
    monkeypatch.setattr(jax_trainer, "init_model_variables",
                        lambda *args, **kwargs: tiny_variables)


def _sessions(setup, name, **port_kwargs):
    make, checkpoint = setup
    config = make(name)
    jax_session, jax_obs, _ = jax_play.load_play_session(copy.deepcopy(config),
                                                         reference_checkpoint=checkpoint)
    session, obs, logger = play.load_play_session(config, device="cpu", **port_kwargs)
    np.testing.assert_array_equal(obs, np.asarray(jax_obs))  # the pinned draw
    return config, jax_session, session, obs, logger


@pytest.mark.parametrize("source", ["reference_checkpoint", "port_checkpoint"])
def test_scripted_rollout_matches_jax(setup, pinned, source):
    """``load_play_session`` (from the reference .pth.tar, and from the
    port's own checkpoint) and the scripted default front end: the same
    start observation and actions, frames within one level."""
    kwargs = {"reference_checkpoint": setup[1]} if source == "reference_checkpoint" else {}
    config, jax_session, session, _, logger = _sessions(setup, source, **kwargs)
    assert not session.model.training
    frames, actions = play.scripted_rollout(session, 3, ROLLOUT_FRAMES, logger)
    want_actions = np.random.default_rng(0).integers(0, 3, size=ROLLOUT_FRAMES)
    assert actions == want_actions.tolist()
    want = np.asarray(jax_session.rollout(want_actions))
    assert frames.dtype == np.uint8 and frames.shape == (ROLLOUT_FRAMES, 32, 32, 3)
    assert np.abs(frames.astype(int) - want.astype(int)).max() <= 1


def test_save_session_matches_jax(setup, tmp_path):
    """The same files, the same ``session.pkl`` and the same PNGs."""
    rng = np.random.default_rng(4)
    frames = [rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32),
              rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)]
    actions, timestamps = [2, 0], [10.0, 10.25]
    for save, name in ((jax_play.save_session, "jax"), (play.save_session, "port")):
        save(frames, actions, str(tmp_path / name), Logger(), timestamps=timestamps)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert "session.pkl" in names and "00001.png" in names
    for name in names:
        if name.endswith(".png"):
            np.testing.assert_array_equal(read_frame(str(tmp_path / "port" / name)),
                                          read_frame(str(tmp_path / "jax" / name)))
    with open(tmp_path / "port" / "session.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax" / "session.pkl", "rb") as f:
        assert got == pickle.load(f) == {"actions": actions, "timestamps": timestamps}
    play.save_session([], [], str(tmp_path / "empty"), Logger())
    assert not os.path.exists(tmp_path / "empty")


def test_interpolate_matches_jax(setup, pinned, monkeypatch):
    """11 sequences with the same directory names, frames and per-frame
    selected actions (the JAX run imports the reference checkpoint, the
    port loads its own of the same weights)."""
    make, checkpoint = setup
    config = make("interpolate")
    jax_config = make("interpolate_jax")
    recorded = {}
    jax_save = jax_play.save_session

    def record(frames, actions, output_dir, logger, timestamps=None):
        recorded[os.path.basename(output_dir)] = (frames, actions)
        jax_save(frames, actions, output_dir, logger, timestamps)

    monkeypatch.setattr(jax_interpolate, "save_session", record)
    monkeypatch.setattr(jax_interpolate, "load_play_session",
                        lambda c: jax_play.load_play_session(c, reference_checkpoint=checkpoint))
    jax_interpolate.interpolate(jax_config, 0, 2, frames_per_sequence=2)
    got = interpolate.interpolate(config, 0, 2, frames_per_sequence=2, device="cpu")

    assert len(got) == 11 and sorted(got) == sorted(recorded)
    for name, frames in got.items():
        want_frames, want_actions = recorded[name]
        np.testing.assert_allclose(np.stack(frames), np.stack(want_frames), **TOL)
        with open(os.path.join(config["logging"]["interpolated_sequences"], name,
                               "session.pkl"), "rb") as f:
            assert pickle.load(f)["actions"] == want_actions
    assert recorded["interp_0_2_0.5"][1] == [0, 0] and recorded["interp_0_2_0.6"][1] == [2, 2]
    assert (sorted(os.listdir(config["logging"]["interpolated_sequences"]))
            == sorted(os.listdir(jax_config["logging"]["interpolated_sequences"])))
    in_memory = interpolate.interpolate(config, 0, 2, factors=[0.3], frames_per_sequence=1,
                                        device="cpu", save=False)
    np.testing.assert_array_equal(in_memory["interp_0_2_0.3"][0], got["interp_0_2_0.3"][0])


def test_interactive_loop_matches_jax(setup, pinned, monkeypatch):
    """A scripted key sequence (two saved sessions, bad keys skipped, an
    unsaved tail, then quit; a key after 'q' is never read) through both
    packages' loops: the same saved sessions, frames within one level."""
    keys = "1\n3\nx\n9\n0\n2\n1\n0\n3\nq\n1\n"
    outputs = {}
    for name, module, load, helper in (
            ("jax", jax_play, lambda c: jax_play.load_play_session(
                c, reference_checkpoint=setup[1]), JaxInputHelper),
            ("port", play, lambda c: play.load_play_session(c, device="cpu"), InputHelper)):
        config = setup[0](f"interactive_{name}")
        session, obs, logger = load(config)
        # The play module's own clock: the session directories' names and
        # the timestamps count its calls only.
        clock = itertools.count(2_000_000_000)
        monkeypatch.setattr(module, "time", SimpleNamespace(
            time=lambda: float(next(clock)), perf_counter=time.perf_counter))
        module.interactive_loop(session, logger, config["logging"]["output_directory"], 3,
                                observation=obs, input_helper=helper(stream=io.StringIO(keys)))
        outputs[name] = config["logging"]["output_directory"]
    sessions = sorted(d for d in os.listdir(outputs["jax"]) if d.startswith("session_"))
    assert len(sessions) == 2
    assert sorted(d for d in os.listdir(outputs["port"]) if d.startswith("session_")) == sessions
    for directory in sessions:
        paths = {name: os.path.join(root, directory) for name, root in outputs.items()}
        assert sorted(os.listdir(paths["port"])) == sorted(os.listdir(paths["jax"]))
        pickles = []
        for name in ("port", "jax"):
            with open(os.path.join(paths[name], "session.pkl"), "rb") as f:
                pickles.append(pickle.load(f))
        assert pickles[0] == pickles[1]
        for png in (f for f in os.listdir(paths["jax"]) if f.endswith(".png")):
            got = read_frame(os.path.join(paths["port"], png)).astype(int)
            want = read_frame(os.path.join(paths["jax"], png)).astype(int)
            assert np.abs(got - want).max() <= 1
    with open(os.path.join(outputs["port"], sessions[0], "session.pkl"), "rb") as f:
        assert pickle.load(f)["actions"] == [0, 2]  # keys 1 and 3; 'x' and '9' skipped


def test_input_helper_matches_jax():
    lines = "1\n\n  7 \nqx\n"
    got, want = InputHelper(stream=io.StringIO(lines)), JaxInputHelper(stream=io.StringIO(lines))
    assert not got.interactive
    assert ([got.read_character() for _ in range(5)] == [want.read_character() for _ in range(5)]
            == ["1", "\n", "7", "q", ""])


CLIS = {"play": play, "interpolate": interpolate, "build_evaluation_dataset": build_cli,
        "evaluate_dataset": evaluate_cli}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_defaults_to_cuda_and_raises_without_it(setup, monkeypatch, tmp_path, name):
    """Each new CLI's ``main`` with no ``--device`` on a machine without a
    GPU raises, naming ``device='cpu'``."""
    config = setup[0](f"cli_{name}")
    if name == "evaluate_dataset":
        config = {"logging": {"run_name": "eval", "output_root": str(tmp_path)},
                  "data": {"target_input_size": [32, 32], "actions_count": 3},
                  "reference_data": {"data_root": config["data"]["data_root"]},
                  "generated_data": {"data_root": config["data"]["data_root"]},
                  "evaluation": {"evaluator": "evaluation.dataset_evaluator",
                                 "batching": config["evaluation"]["batching"]}}
    path = tmp_path / "config.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    argv = [name, "--config", str(path)]
    if name == "interpolate":
        argv += ["--first-action", "0", "--second-action", "1"]
    monkeypatch.setattr(sys, "argv", argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CLIS[name].main()
