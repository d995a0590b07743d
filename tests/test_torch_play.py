"""Parity of the port's play route with the JAX package, on the CPU.

The JAX model and the port get the same seeded numpy weights (BatchNorm
statistics far from (0, 1)) and the same inputs; frames, carries and
windows must agree in f32 at rtol 1e-3 / atol 2e-4 on the tiny model, and
uint8 frames to within 1.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    random_variables, single_threaded_torch)

from playablevideogeneration_tpu.inference.play_session import PlaySession as JaxPlaySession
from playablevideogeneration_tpu.models.caddy import Caddy as JaxCaddy
from playablevideogeneration_tpu.models.caddy import init_model_variables
from playablevideogeneration_tpu_torch.inference.play_session import (
    PlaySession,
    frame_to_uint8,
)
from playablevideogeneration_tpu_torch.models.caddy import Caddy, flagship_model, make_model
from playablevideogeneration_tpu_torch.utils.device import resolve_device
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-3, atol=2e-4)


def _port_of(jax_model):
    return Caddy(jax_model.actions_count, jax_model.action_space_dimension,
                 jax_model.state_features, jax_model.state_resolution,
                 jax_model.hidden_state_size, jax_model.observation_stacking).eval()


@pytest.fixture(scope="module")
def tiny_pair(tiny_model, tiny_variables):
    """(JAX variables, port model) with the same seeded weights; the
    session fixture ``tiny_variables`` is only read for its shapes."""
    variables = random_variables(tiny_variables, seed=3)
    return variables, load_jax_variables(_port_of(tiny_model), variables)


def _window(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _assert_carry_close(got, want, **tol):
    for (gh, gc), (wh, wc) in zip(got, want):
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **tol)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **tol)


def _play_steps(jax_model, variables, port, window, steps, **tol):
    """Chains ``steps`` play steps through both; a nonzero variation
    exercises the variation channels."""
    rng = np.random.default_rng(9)
    jax_step = jax.jit(lambda v, *a: jax_model.apply(v, *a, method="play_step"))
    jax_carry = jax_model.apply(variables, 1, method="init_play")
    carry = port.init_play(1)
    _assert_carry_close(carry, jax_carry, rtol=0, atol=0)
    jax_window, torch_window = jnp.asarray(window), torch.from_numpy(window)
    for _ in range(steps):
        action = np.eye(port.actions_count, dtype=np.float32)[
            [rng.integers(port.actions_count)]]
        variation = rng.normal(size=(1, port.action_space_dimension)).astype(np.float32)
        jax_carry, want_frame, jax_window = jax_step(
            variables, jax_carry, jax_window, jnp.asarray(action), jnp.asarray(variation))
        carry, frame, torch_window = port.play_step(
            carry, torch_window, torch.from_numpy(action), torch.from_numpy(variation))
        np.testing.assert_allclose(frame.numpy(), np.asarray(want_frame), **tol)
        np.testing.assert_allclose(torch_window.numpy(), np.asarray(jax_window), **tol)
        _assert_carry_close(carry, jax_carry, **tol)


def test_tiny_play_step_matches_jax(tiny_model, tiny_pair):
    variables, port = tiny_pair
    _play_steps(tiny_model, variables, port, _window((1, 32, 32, 6), 1), steps=3, **TOL)


def test_tiny_play_session_matches_jax(tiny_model, tiny_pair):
    variables, port = tiny_pair
    obs = _window((32, 32, 6), 2)
    want = JaxPlaySession(tiny_model, variables).start(obs)
    got = PlaySession(port).start(obs)
    for action in (0, 2, 1):
        np.testing.assert_allclose(got.generate_next(action), want.generate_next(action),
                                   **TOL)
    got_u8, want_u8 = got.generate_next_u8(1), np.asarray(want.generate_next_u8(1))
    assert got_u8.dtype == np.uint8 and got_u8.shape == (32, 32, 3)
    assert np.abs(got_u8.astype(int) - want_u8.astype(int)).max() <= 1
    device_u8 = got.generate_next_u8(2, block=False)
    want_u8 = np.asarray(want.generate_next_u8(2))
    assert isinstance(device_u8, torch.Tensor)
    assert np.abs(device_u8.numpy().astype(int) - want_u8.astype(int)).max() <= 1
    for factor in (0.3, 0.8):
        np.testing.assert_allclose(got.generate_next_interpolation(0, 2, factor),
                                   want.generate_next_interpolation(0, 2, factor), **TOL)
    actions = np.array([0, 1, 2, 1])
    got_frames, want_frames = got.rollout(actions), np.asarray(want.rollout(actions))
    assert got_frames.dtype == np.uint8 and got_frames.shape == (4, 32, 32, 3)
    assert np.abs(got_frames.astype(int) - want_frames.astype(int)).max() <= 1
    with pytest.raises(ValueError):
        got.generate_next(3)


def test_play_session_noise_is_seeded(tiny_pair):
    _, port = tiny_pair
    obs = _window((32, 32, 6), 5)
    runs = [PlaySession(port, noise=True, seed=s).start(obs).rollout(np.array([0, 1]))
            for s in (7, 7, 8)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])


def test_frame_to_uint8_matches_jax():
    from playablevideogeneration_tpu.inference.play_session import (
        frame_to_uint8 as jax_frame_to_uint8,
    )
    frame = _window((4, 5, 3), 6) * 1.2
    np.testing.assert_array_equal(frame_to_uint8(frame), jax_frame_to_uint8(frame))
    u8 = jax_frame_to_uint8(frame)
    assert frame_to_uint8(u8) is u8


def test_flagship_play_step_matches_jax():
    """One flagship-width step (256x256, hidden 128, 64 state features at
    32x32) in f32, at the tiny model's tolerance; the two frameworks' conv
    summation orders leave about 5e-7 between them here."""
    jax_model = JaxCaddy(actions_count=7, action_space_dimension=2, state_features=64,
                         state_resolution=(32, 32), hidden_state_size=128,
                         observation_stacking=1)
    shapes = jax.eval_shape(
        lambda: init_model_variables(jax_model, jax.random.PRNGKey(0),
                                     jnp.zeros((1, 2, 256, 256, 3)),
                                     jnp.zeros((1, 2), jnp.int32)))
    variables = random_variables(shapes, seed=4)
    port = load_jax_variables(flagship_model(device="cpu", dtype=torch.float32), variables)
    _play_steps(jax_model, variables, port, _window((1, 256, 256, 3), 7), steps=1, **TOL)


def _without(tree, path):
    head, *rest = path
    return {k: (_without(v, rest) if k == head and rest else v)
            for k, v in tree.items() if not (k == head and not rest)}


def test_load_jax_variables_rejects_missing_extra_and_misshaped_leaves(
        tiny_model, tiny_pair):
    variables, _ = tiny_pair
    fresh = lambda: _port_of(tiny_model)  # noqa: E731
    missing = _without(variables, ["params", "dynamics_network", "lstm1", "cell",
                                   "gates", "bias"])
    with pytest.raises(KeyError, match="lstm1.cell.gates.bias"):
        load_jax_variables(fresh(), missing)
    extra = dict(variables, batch_stats=dict(
        variables["batch_stats"], rendering_network=dict(
            variables["batch_stats"]["rendering_network"],
            res9={"bn1": {"BatchNorm_0": {"mean": np.zeros(2, np.float32)}}})))
    with pytest.raises(KeyError, match="res9"):
        load_jax_variables(fresh(), extra)
    misshaped = _without(variables, ["model_state", "centroids"])
    misshaped["model_state"]["centroids"] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match="centroids"):
        load_jax_variables(fresh(), misshaped)
    with pytest.raises(KeyError, match="collections"):
        load_jax_variables(fresh(), dict(variables, cache={}))


def test_flagship_model_matches_bair_config():
    with open(os.path.join(REPO, "configs", "01_bair.yaml")) as f:
        config = yaml.safe_load(f)
    from_config = make_model(config, device="cpu", seed=1)
    flagship = flagship_model(device="cpu", seed=1)
    for attr in ("actions_count", "action_space_dimension", "state_features",
                 "state_resolution", "hidden_state_size", "observation_stacking",
                 "dtype"):
        assert getattr(from_config, attr) == getattr(flagship, attr), attr
    assert flagship.dtype == torch.bfloat16
    want = flagship.state_dict()
    got = from_config.state_dict()
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from playablevideogeneration_tpu_torch.cli.build_evaluation_dataset import (
        build_evaluation_dataset,
        make_evaluation_dataset_builder,
    )
    from playablevideogeneration_tpu_torch.cli.evaluate_dataset import evaluate_dataset
    from playablevideogeneration_tpu_torch.cli.interpolate import interpolate
    from playablevideogeneration_tpu_torch.cli.play import load_play_session, load_trained_model
    from playablevideogeneration_tpu_torch.utils.pretrained import make_metric_vgg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship_model()
    # The entry points after training resolve the device before they read
    # anything of the config.
    for entry in (lambda: load_play_session({}), lambda: load_trained_model({}, "test"),
                  lambda: interpolate({}, 0, 1), lambda: build_evaluation_dataset({}),
                  lambda: make_evaluation_dataset_builder({}), lambda: evaluate_dataset({}),
                  lambda: make_metric_vgg(None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_no_jax():
    """The port and chip_smoke.py import with jax, flax and the JAX
    package (by exact top-level name) blocked."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        BLOCKED = {"jax", "jaxlib", "flax", "playablevideogeneration_tpu"}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import playablevideogeneration_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not leaked, leaked
        print(" ".join(names))
    """)
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                            text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    imported = set(result.stdout.split())
    covered = {f"playablevideogeneration_tpu_torch.{name}" for name in (
        "models.action", "models.centroids", "models.gumbel", "models.outputs", "models.vgg",
        "training.bench_harness", "training.losses", "training.schedules",
        "training.smooth_mi", "training.train_state", "training.trainer",
        "utils.tensor_ops",
        # after training: play, interpolate, reference import, offline evaluation
        "cli.play", "cli.interpolate", "cli.build_evaluation_dataset", "cli.evaluate_dataset",
        "utils.reference_checkpoint", "utils.input_helper", "utils.video_saver",
        "utils.pretrained", "evaluation.builder", "evaluation.dataset_evaluator",
        "evaluation.metrics.frame_metrics", "evaluation.metrics.lpips",
        "evaluation.metrics.detection", "evaluation.metrics.action_metrics",
        "evaluation.plotting.density_plots",
        # the distribution metrics: FID, FVD, Inception Score and the FID CLI
        "cli.fid", "evaluation.metrics.inception", "evaluation.metrics.i3d",
        "evaluation.metrics.fid", "evaluation.metrics.fvd",
        # the convergence soak, the Faster R-CNN detector, the results plotter
        "tools", "tools.convergence_soak", "tools.action_space_diag",
        "evaluation.metrics.frcnn", "evaluation.plotting.results_plotter")}
    assert covered <= imported and len(imported) >= 56
