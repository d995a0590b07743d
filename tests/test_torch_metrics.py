"""Parity of the port's offline-evaluation metrics with the JAX package, on
the CPU: frame metrics, VGG cosine similarity, LPIPS, the Fréchet
distance, detection, the action-space metrics and the positional
statistics; and the non-slow cases of tests/test_metrics.py and
tests/test_dataset_evaluation.py that these modules cover.

Inputs are seeded [0, 1] frames.  Frame metrics, VGG similarity and LPIPS
agree within rtol 1e-5 (the VGG19 tree is carried across, since the two
packages' random inits differ); the host-side numpy metrics are exact.
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
from torch_parity import random_variables, single_threaded_torch  # noqa: F401

from playablevideogeneration_tpu.evaluation import dataset_evaluator as jax_evaluator
from playablevideogeneration_tpu.evaluation.metrics import action_metrics as jax_action
from playablevideogeneration_tpu.evaluation.metrics import detection as jax_detection
from playablevideogeneration_tpu.evaluation.metrics import frame_metrics as jax_frame
from playablevideogeneration_tpu.evaluation.metrics import lpips as jax_lpips
from playablevideogeneration_tpu.models import vgg as jax_vgg
from playablevideogeneration_tpu.utils import pretrained as jax_pretrained
from playablevideogeneration_tpu_torch.evaluation import dataset_evaluator
from playablevideogeneration_tpu_torch.evaluation.metrics import action_metrics, detection
from playablevideogeneration_tpu_torch.evaluation.metrics import frame_metrics, lpips
from playablevideogeneration_tpu_torch.models.vgg import Vgg19
from playablevideogeneration_tpu_torch.utils import pretrained
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def _pair(seed=0, b=2, t=3, h=16, w=16):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, size=(b, t, h, w, 3)).astype(np.float32)
    bb = np.clip(a + rng.normal(0, 0.1, size=a.shape), 0, 1).astype(np.float32)
    return a, bb


def _both(fn_port, fn_jax, *arrays):
    got = fn_port(*(torch.from_numpy(a) for a in arrays))
    want = fn_jax(*(jnp.asarray(a) for a in arrays))
    return got.numpy(), np.asarray(want)


@pytest.fixture(scope="module")
def vgg_variables():
    shapes = jax.eval_shape(jax_vgg.random_vgg_variables, jax.random.PRNGKey(0))
    return random_variables(shapes, seed=51)


# --------------------------------------------------------------------- #
# Frame metrics against JAX                                             #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["mse", "psnr", "motion_masked_mse", "ssim", "motion_mask"])
def test_frame_metric_matches_jax(name):
    ref, gen = _pair(1, h=24, w=20)
    got, want = _both(getattr(frame_metrics, name), getattr(jax_frame, name),
                      *((ref,) if name == "motion_mask" else (ref, gen)))
    assert got.shape == want.shape == ((2, 3, 24, 20, 1) if name == "motion_mask" else (2, 3))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_vgg_cosine_similarity_matches_jax(vgg_variables):
    ref, gen = _pair(2, h=32, w=32)
    vgg = load_jax_variables(Vgg19(), vgg_variables)
    with torch.no_grad():
        got = frame_metrics.vgg_cosine_similarity(vgg, torch.from_numpy(ref),
                                                  torch.from_numpy(gen)).numpy()
    want = np.asarray(jax_frame.vgg_cosine_similarity(
        jax_vgg.make_vgg_apply(vgg_variables), jnp.asarray(ref), jnp.asarray(gen)))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_lpips_matches_jax_with_heads_from_the_jax_writer(vgg_variables, tmp_path, monkeypatch):
    """Converted weights written by the JAX package (``save_variables_npz``
    for VGG19, the converter's ``lin<i>`` arrays for the heads), found
    through ``PVG_PRETRAINED_WEIGHTS`` by both packages; and LPIPS without
    heads."""
    rng = np.random.default_rng(5)
    jax_pretrained.save_variables_npz(vgg_variables, str(tmp_path / "vgg19.npz"))
    heads = {f"lin{i}": rng.uniform(0, 1, c).astype(np.float32)
             for i, c in enumerate((64, 128, 256, 512, 512))}
    np.savez(tmp_path / "lpips_lin.npz", **heads)
    monkeypatch.setenv("PVG_PRETRAINED_WEIGHTS", str(tmp_path))
    config = {"tpu": {}}
    got_fn = pretrained.get_lpips_fn(config, device="cpu")
    want_fn = jax_pretrained.get_lpips_fn(config)
    ref, gen = _pair(3, h=32, w=32)
    with torch.no_grad():
        got, want = _both(got_fn, want_fn, ref, gen)
    assert got.shape == (2, 3) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL)

    vgg = load_jax_variables(Vgg19(), vgg_variables)
    with torch.no_grad():
        got, want = _both(lpips.make_lpips_fn(vgg),
                          jax_lpips.make_lpips_fn(jax_vgg.make_vgg_apply(vgg_variables)),
                          ref, gen)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    loaded = lpips.load_lpips_linear_weights(str(tmp_path / "lpips_lin.npz"))
    for i, head in enumerate(loaded):
        np.testing.assert_array_equal(head, heads[f"lin{i}"])


def test_pretrained_files_round_trip_and_resolve(vgg_variables, tmp_path, monkeypatch):
    """The port reads the JAX writer's ``.npz`` and writes one the JAX
    reader reads; files resolve from an explicit path, the config's
    directory and the environment's, in that order."""
    jax_pretrained.save_variables_npz(vgg_variables, str(tmp_path / "a" / "vgg19.npz"))
    pretrained.save_variables_npz(pretrained.load_variables_npz(str(tmp_path / "a" / "vgg19.npz")),
                                  str(tmp_path / "b" / "vgg19.npz"))
    back = jax_pretrained.load_variables_npz(str(tmp_path / "b" / "vgg19.npz"))
    for name, leaf in vgg_variables["params"].items():
        for key in leaf:
            np.testing.assert_array_equal(back["params"][name][key], leaf[key])
    monkeypatch.setenv("PVG_PRETRAINED_WEIGHTS", str(tmp_path / "a"))
    for config in ({"tpu": {}},
                   {"tpu": {"pretrained_weights_dir": str(tmp_path / "b")}},
                   {"tpu": {"pretrained_weights": {"vgg19": str(tmp_path / "b" / "vgg19.npz")}}},
                   {"tpu": {"pretrained_weights": {"vgg19": str(tmp_path / "missing.npz")}}}):
        try:
            want = jax_pretrained.find_weights(config, "vgg19")
        except FileNotFoundError:
            with pytest.raises(FileNotFoundError):
                pretrained.find_weights(config, "vgg19")
            continue
        assert pretrained.find_weights(config, "vgg19") == want
        assert pretrained.find_weights(config, "lpips_lin") is None
    variables, found = pretrained.get_vgg_variables({"tpu": {}})
    assert found and sorted(variables["params"]) == sorted(vgg_variables["params"])
    monkeypatch.delenv("PVG_PRETRAINED_WEIGHTS")
    assert pretrained.get_vgg_variables({"tpu": {}}) == (None, False)
    assert pretrained.get_lpips_fn({"tpu": {}}, device="cpu") is None


@pytest.mark.parametrize("backbone", ["fid_inception", "i3d"])
def test_unported_backbones_raise_when_their_weights_are_found(tmp_path, backbone):
    path = tmp_path / pretrained.WEIGHT_FILES[backbone]
    np.savez(path, x=np.zeros(1))
    config = {"tpu": {"pretrained_weights_dir": str(tmp_path)},
              "evaluation": {"compute_inception_score": True}}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pretrained.evaluation_backbones(config, device="cpu")


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(6)
    x, y = rng.normal(size=(300, 6)), rng.normal(0.3, 1.2, size=(300, 6))
    args = (x.mean(0), np.cov(x, rowvar=False), y.mean(0), np.cov(y, rowvar=False))
    assert frame_metrics.frechet_distance(*args) == jax_frame.frechet_distance(*args)
    mu, sigma = args[:2]
    assert abs(frame_metrics.frechet_distance(mu, sigma, mu, sigma)) < 1e-6
    shift = np.eye(6)[0]
    assert abs(frame_metrics.frechet_distance(mu, sigma, mu + shift, sigma) - 1.0) < 1e-6


# --------------------------------------------------------------------- #
# Host-side metrics: exact                                              #
# --------------------------------------------------------------------- #


def _square_frames():
    size, square = 48, 4
    xs = [2, 8, 14, 20, 26, 32, 38, 44]
    frames = np.full((len(xs), size, size, 3), 0.1, np.float32)
    for t, x in enumerate(xs):
        frames[t, 20:20 + square, x:x + square] = (0.9, 0.2, 0.2)
    return frames, xs, square


def test_blob_detector_matches_jax_and_tracks_the_square():
    frames, xs, square = _square_frames()
    boxes = detection.motion_blob_boxes(frames)
    assert boxes == jax_detection.motion_blob_boxes(frames)
    centers = detection.TennisPlayerDetector(backend="blob")(frames[None])
    np.testing.assert_array_equal(
        centers, jax_detection.TennisPlayerDetector(backend="blob")(frames[None]))
    ok = centers[0, :, 0] != -1
    assert ok.sum() >= len(xs) - 1
    np.testing.assert_allclose(centers[0, ok, 0], np.asarray(xs, np.float64)[ok] + square / 2,
                               atol=1.5)
    np.testing.assert_array_equal(detection.TennisPlayerDetector()(frames[None]),
                                  np.full((1, len(xs), 2), -1.0))


def test_court_filter_and_tallest_selection_match_jax():
    w, h = 256, 96
    boxes = [(5, 5, 50, 20), (210, 2, 250, 20), (100, 80.5, 120, 95), (100, 30, 110, 60),
             (150, 30, 160, 70)]
    for box in boxes:
        assert detection.court_box_filter(box, w, h) == jax_detection.court_box_filter(box, w, h)
    assert detection.select_player_center(boxes, w, h) == (155.0, 50.0)
    assert detection.select_player_center(boxes[:1], w, h) == (-1.0, -1.0)


def test_breakout_positions_match_jax():
    obs = np.zeros((1, 3, 100, 60, 3), np.float32)
    obs[0, 0, 90:96, 20:30, 0] = 0.8
    obs[0, 1, 90:96, 40:50, 0] = 0.8
    got = detection.breakout_platform_positions(obs)
    np.testing.assert_array_equal(got, jax_detection.breakout_platform_positions(obs))
    assert got.shape == (1, 3, 1) and got[0, 2, 0] == -1.0
    assert abs(got[0, 0, 0] - 24.5) < 1.0 and abs(got[0, 1, 0] - 44.5) < 1.0


def test_detection_metric_matches_jax():
    rng = np.random.default_rng(7)
    ref = rng.uniform(0, 10, (4, 5, 2))
    gen = ref + rng.normal(0, 1, ref.shape)
    ref[0, 1] = -1
    gen[1, 2] = -1
    gen[:, 4] = -1
    got = detection.detection_metric(ref, gen, "det")
    assert got == jax_detection.detection_metric(ref, gen, "det")
    assert got["det/mdr/4"] == 1.0 and got["det/add/4"] == -1.0


def test_make_detector_matches_jax_and_refuses_frcnn():
    for spec in (None, "none", "blob"):
        got = detection.make_detector({"evaluation": {"detector": spec}})
        want = jax_detection.make_detector({"evaluation": {"detector": spec}})
        assert got.available == want.available
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        detection.make_detector({"evaluation": {"detector": "frcnn"}})


def _movements(seed=8, n=60, actions=3):
    rng = np.random.default_rng(seed)
    inferred = rng.integers(0, actions, n)
    centers = np.array([[-2.0, 0.0], [2.0, 0.5], [0.0, 2.0]])
    return inferred, centers[inferred] + rng.normal(0, 0.4, (n, 2))


def test_action_variance_matches_jax():
    inferred, vectors = _movements()
    inferred[inferred == 1] = 0  # an action that never occurs
    got = action_metrics.action_variance(inferred, vectors, 3)
    assert got == jax_action.action_variance(inferred, vectors, 3)
    assert "action_variance/frequency/1" not in got
    actions = np.array([0, 1, 0, 1])
    small = action_metrics.action_variance(actions, np.array([[1.0, 0], [0, 1], [3.0, 0],
                                                              [0, 3]]), 2)
    np.testing.assert_allclose(small["action_variance/mean_vector/0"], [2.0, 0.0])
    np.testing.assert_allclose(small["action_variance/variance_vector/0"], [1.0, 0.0])
    assert small["action_variance/frequency/0"] == 0.5


@pytest.mark.parametrize("case", ["separable", "single_class"])
def test_action_classification_matches_jax(case):
    inferred, vectors = _movements(9)
    if case == "single_class":
        inferred = np.zeros_like(inferred)
    got = action_metrics.action_classification_score(inferred, vectors, 3)
    want = jax_action.action_classification_score(inferred, vectors, 3)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, float) and np.isnan(value):
            assert np.isnan(got[key]), key
        else:
            assert got[key] == value, key
    if case == "separable":
        assert got["action_classification/linear/accuracy"] > 0.95


def test_action_classification_without_scikit_learn():
    script = textwrap.dedent("""
        import sys
        import numpy as np

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] == "sklearn":
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        from playablevideogeneration_tpu_torch.evaluation.metrics.action_metrics import (
            action_classification_score)
        result = action_classification_score(np.array([0, 1]), np.ones((2, 2)), 2)
        assert result == {"action_classification_unavailable": "scikit-learn not installed"}, result
    """)
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                            text=True, timeout=120)
    assert result.returncode == 0, result.stderr


def test_positional_statistics_match_jax():
    values = np.random.default_rng(10).normal(size=(5, 4))
    got = dataset_evaluator.compute_positional_statistics(values, "m")
    assert got == jax_evaluator.compute_positional_statistics(values, "m")
    small = dataset_evaluator.compute_positional_statistics(np.array([[1.0, 2.0], [3.0, 4.0]]),
                                                            "m")
    assert small["m/0"] == 2.0 and small["m/1"] == 3.0 and small["m/avg"] == 2.5
    assert small["m/0/var"] == 1.0
    accumulator = dataset_evaluator.MetricsAccumulator()
    accumulator.add("a", np.ones((2, 3)))
    accumulator.add("a", np.zeros((1, 3)))
    assert accumulator.pop("a").shape == (3, 3) and accumulator.pop("a").shape == (0,)


# --------------------------------------------------------------------- #
# tests/test_metrics.py's properties, on the port                       #
# --------------------------------------------------------------------- #


def test_mse_psnr_shapes_and_identity():
    a, b = map(torch.from_numpy, _pair())
    assert frame_metrics.mse(a, b).shape == (2, 3)
    np.testing.assert_allclose(frame_metrics.mse(a, a).numpy(), 0.0, atol=1e-7)
    psnr = frame_metrics.psnr(a, b).numpy()
    assert (psnr > 15).all() and (psnr < 30).all()
    np.testing.assert_allclose(psnr, -10 * np.log10(frame_metrics.mse(a, b).numpy()), rtol=1e-4)
    np.testing.assert_allclose(frame_metrics.motion_masked_mse(a, a).numpy(), 0.0, atol=1e-7)


def test_ssim_bounds_and_independent_reference():
    """SSIM of identical frames is 1, of noisy copies in (0, 1), lower for
    inverted ones; and it matches an independent scipy implementation of
    Wang et al. with piq's defaults."""
    from scipy.ndimage import convolve

    a, b = _pair(1, h=32, w=32)
    np.testing.assert_allclose(frame_metrics.ssim(torch.from_numpy(a), torch.from_numpy(a)),
                               1.0, atol=1e-4)
    s = frame_metrics.ssim(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (s < 1.0).all() and (s > 0.0).all()
    assert (frame_metrics.ssim(torch.from_numpy(a), torch.from_numpy(1.0 - a)).numpy() < s).all()

    half = 5
    g = np.exp(-((np.arange(11) - half) ** 2) / (2 * 1.5 ** 2))
    window = np.outer(g / g.sum(), g / g.sum())

    def valid(img):
        return convolve(img, window, mode="constant")[half:-half, half:-half]

    want = np.zeros_like(s)
    for i in range(a.shape[0]):
        for t in range(a.shape[1]):
            per_channel = []
            for c in range(3):
                x, y = a[i, t, :, :, c].astype(np.float64), b[i, t, :, :, c].astype(np.float64)
                mx, my = valid(x), valid(y)
                sx, sy, sxy = valid(x * x) - mx * mx, valid(y * y) - my * my, valid(x * y) - mx * my
                per_channel.append((((2 * mx * my + 1e-4) * (2 * sxy + 9e-4))
                                    / ((mx * mx + my * my + 1e-4) * (sx + sy + 9e-4))).mean())
            want[i, t] = np.mean(per_channel)
    np.testing.assert_allclose(s, want, rtol=1e-4, atol=1e-5)
