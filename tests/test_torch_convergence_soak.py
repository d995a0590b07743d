"""The port's convergence soak and its action-space diagnostic on the CPU,
against the JAX package's tools: the run config, the synthetic videos, the
(action, movement) pairs, and a tiny soak that resumes and misses its
target; then the diagnostic on that run.
"""
import argparse
import contextlib
import io
import json
import os

import numpy as np
import pytest
from torch_parity import single_threaded_torch  # noqa: F401 (an autouse fixture)

import tools.convergence_soak as jax_soak
from playablevideogeneration_tpu.config.configuration import Configuration as JaxConfiguration
from playablevideogeneration_tpu.data.loader import DataLoader as JaxDataLoader
from playablevideogeneration_tpu.data.synthetic import build_synthetic_dataset
from playablevideogeneration_tpu.data.transforms import get_final_transforms as jax_transforms
from playablevideogeneration_tpu.data.video import Video as JaxVideo
from playablevideogeneration_tpu.data.video_dataset import VideoDataset as JaxVideoDataset
from playablevideogeneration_tpu_torch.tools import action_space_diag
from playablevideogeneration_tpu_torch.tools import convergence_soak as soak

# A soak small enough for the CPU: 16x16 frames, hidden 8, batch 4,
# 2 videos of 12 frames per split (14 evaluation samples of 6 frames).
TINY = ["--device", "cpu", "--size", "16", "--hidden-state-size", "8", "--state-features",
        "8", "--batch-size", "4", "--pretraining-steps", "2", "--eval-every", "2",
        "--eval-batches", "1", "--videos-per-split", "2", "--video-length", "12",
        "--fixed-y", "--no-example-images"]


def _args(root, *extra):
    return soak.parse_args(["--root", str(root), *extra])


@pytest.mark.parametrize("extra", [
    [],
    ["--fixed-y"],
    ["--no-variations"],
    ["--model-actions", "7", "--actions", "5", "--action-space-dimension", "2"],
    ["--fixed-y", "--no-variations", "--steps", "12000", "--eval-every", "500",
     "--compute-dtype", "float32", "--remat", "1"],
])
def test_build_config_matches_the_jax_tool(tmp_path, extra):
    args = _args(tmp_path, *extra)
    assert soak.build_config(args) == jax_soak.build_config(args)


def test_videos_equal_the_written_dataset(tmp_path):
    """The in-memory split videos equal those build_synthetic_dataset (the
    JAX package's) writes and reads back: frames, actions, metadata."""
    args = _args(tmp_path, "--size", "20", "--videos-per-split", "2", "--video-length", "9",
                 "--actions", "5", "--fixed-y")
    build_synthetic_dataset(str(tmp_path / "data"), videos_per_split=2, length=9, height=20,
                            width=20, actions_count=5, square=10, step_pixels=4, fixed_y=5)
    videos = soak.make_split_videos(args)
    for directory, name in soak.SPLITS:
        root = tmp_path / "data" / directory
        written = [JaxVideo().load(str(root / d)) for d in sorted(os.listdir(root))]
        assert len(written) == len(videos[name]) == 2
        for want, got in zip(written, videos[name]):
            assert got.actions == want.actions
            assert got.metadata == want.metadata
            assert got.get_frames_count() == want.get_frames_count() == 9
            for i in range(9):
                np.testing.assert_array_equal(got.get_frame_at(i),
                                              np.asarray(want.get_frame_at(i)))


class _StubJaxEvaluator:
    """The JAX evaluator's interface that collect_action_movements uses,
    inferring action 0 everywhere: the movements do not depend on it."""

    def set_action_sampler(self, sampler):
        pass

    def _forward(self, variables, observations, actions, rng, observations_count):
        return argparse.Namespace(
            selected_actions=np.zeros(observations.shape[:1] + (observations_count - 1,), int))


def test_collect_action_movements_matches_the_jax_tool(tmp_path):
    """The port's pairs on its tiny model over the in-memory test split:
    the movements equal the JAX tool's over the written split, exactly,
    and the recorded actions are the videos'."""
    args = _args(tmp_path, *TINY, "--actions", "5", "--videos-per-split", "3")
    config = JaxConfiguration(config=jax_soak.build_config(args))
    config.check_config(check_data_root=False)
    config = config.get_config()
    build_synthetic_dataset(config["data"]["data_root"], videos_per_split=3, length=12,
                            height=16, width=16, actions_count=5, square=10, step_pixels=4,
                            fixed_y=3)
    jax_test = JaxVideoDataset(os.path.join(config["data"]["data_root"], "test"),
                               config["evaluation"]["batching"], jax_transforms(config)["test"])
    want_actions, want_movements = jax_soak.collect_action_movements(
        _StubJaxEvaluator(), None, {"test": jax_test})

    _, datasets, _, evaluators = soak.build_soak(args, soak.RecordingLogger(
        str(tmp_path / "log.jsonl")))
    actions, movements, recorded = soak.collect_action_movements(
        evaluators["validation"], datasets, recorded_actions=True)
    np.testing.assert_array_equal(movements, want_movements)
    # 21 test samples of 6 frames: 2 batches of 8, 5 transitions each.
    assert actions.shape == want_actions.shape == (2 * 8 * 5,)
    assert actions.min() >= 0 and actions.max() < 5
    loader = JaxDataLoader(jax_test, batch_size=8, shuffle=False, drop_last=True,
                           num_workers=1)
    np.testing.assert_array_equal(
        recorded, np.concatenate([b.actions[:, :-1].reshape(-1) for b in loader]))
    assert evaluators["validation"].model.training  # the mode was restored


def test_tiny_soak_writes_its_evidence_resumes_and_reports_a_miss(tmp_path):
    root = tmp_path / "soak"
    # A run split in two invocations: the first stops at step 2 without
    # the evidence, the second resumes there.
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        soak.main(["--root", str(root), *TINY, "--steps", "4", "--stop-at", "2"])
    assert "[soak] stopped at step 2 of 4" in printed.getvalue()
    assert not (root / "artifacts").exists()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        soak.main(["--root", str(root), *TINY, "--steps", "4", "--target-accuracy", "0"])
    assert "[soak] resumed at step 2" in printed.getvalue()
    assert "step: 3/4" in printed.getvalue() and "step: 2/4" not in printed.getvalue()
    summary = json.loads((root / "artifacts" / "summary.json").read_text())
    assert summary["steps"] == 4 and summary["target_met"] and summary["device"] == "cpu"
    curve = [json.loads(line) for line in (root / "eval_curve.jsonl").read_text().splitlines()]
    assert [r["step"] for r in curve] == [2, 4]
    for record in curve:
        assert all(np.isfinite(record[k]) for k in (
            "observations_loss", "perceptual_loss", "states_loss", "actions_accuracy",
            "one_hot_actions_accuracy"))
    log = [json.loads(line) for line in (root / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log if "train/loss" in r] == [1]
    assert all(np.isfinite(r["train/loss"]) for r in log if "train/loss" in r)
    checkpoints = root / "out" / "checkpoints" / "synthetic"
    assert sorted(os.listdir(checkpoints)) == ["best_accuracy", "latest"]
    assert json.loads((root / "run_args.json").read_text())["steps"] == 4

    # A rerun with more steps resumes at step 4, and a target it cannot
    # reach fails the run after writing the summary.
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), pytest.raises(SystemExit) as exit_info:
        soak.main(["--root", str(root), *TINY, "--steps", "6", "--target-accuracy", "1.01"])
    assert exit_info.value.code == 1
    assert "[soak] resumed at step 4" in printed.getvalue()
    assert "step: 5/6" in printed.getvalue() and "step: 1/6" not in printed.getvalue()
    summary = json.loads((root / "artifacts" / "summary.json").read_text())
    assert summary["steps"] == 6 and not summary["target_met"]
    assert summary["first_eval"]["step"] == 2 and summary["last_eval"]["step"] == 6
    log = [json.loads(line) for line in (root / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log if "train/loss" in r] == [1]  # logged every 10 steps

    # The diagnostic on that run.
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        action_space_diag.main(["--root", str(root), "--device", "cpu", "--max-batches", "2"])
    lines = printed.getvalue().splitlines()
    assert "[diag] checkpoint at step 6" in lines
    result = json.loads(lines[-1])
    assert result["transitions"] == 8 * 5  # 14 test samples: one batch of 8
    assert 0.0 <= result["accuracy_vs_motion"] <= 1.0
    assert 0.0 <= result["accuracy_vs_recorded_actions"] <= 1.0


def test_motion_labels_follow_the_synthetic_action_order():
    movements = np.asarray([[0, 0], [-4, 0], [4, 0], [0, -4], [0, 4]], float)
    np.testing.assert_array_equal(action_space_diag.motion_labels(movements, 5), [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(action_space_diag.motion_labels(movements, 3), [0, 1, 2, 0, 0])


def test_chip_smoke_soak_is_the_breakout_fixed_row_setting_cut_in_steps(tmp_path):
    """``chip_smoke.py`` phase 13 runs docs/CONVERGENCE.md's
    breakout_fixed_row command at the tool's widths and dtype, with fewer
    steps (and so shorter schedules) and no example images."""
    import re

    import chip_smoke

    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "docs",
                           "CONVERGENCE.md")) as f:
        command = re.search(r"convergence_soak\.py (--root \S+ .*?--artifact-dir)",
                            f.read().replace("\\\n", " "), re.S).group(1)
    documented = soak.parse_args(command.split()[:-1])
    smoke = soak.parse_args(["--root", str(tmp_path), *chip_smoke.SOAK_ARGS])
    for name, value in vars(documented).items():
        if name not in ("root", "steps", "pretraining_steps", "eval_every",
                        "no_example_images"):
            assert getattr(smoke, name) == value, name
    assert smoke.compute_dtype == "bfloat16" and smoke.fixed_y and smoke.actions == 3
    assert (smoke.steps, smoke.pretraining_steps, smoke.eval_every) == (100, 20, 50)
    assert smoke.no_example_images and smoke.device == "cuda"
    assert chip_smoke.SOAK_FIRST_STOP % smoke.eval_every == 0
