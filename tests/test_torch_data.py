"""Parity of the port's configuration and data pipeline with the JAX
package, on the CPU: configuration dicts, synthetic videos, the on-disk
video format, dataset samples and loader batches must be equal, exactly.
"""
import copy
import os
import tomllib

import numpy as np
import pytest
import yaml

import chip_smoke
from playablevideogeneration_tpu.config.configuration import (
    Configuration as JaxConfiguration,
    EvaluationConfiguration as JaxEvaluationConfiguration,
)
from playablevideogeneration_tpu.data import synthetic as jax_synthetic
from playablevideogeneration_tpu.data import transforms as jax_transforms
from playablevideogeneration_tpu.data.loader import DataLoader as JaxDataLoader
from playablevideogeneration_tpu.data.splitter import generate_splits as jax_generate_splits
from playablevideogeneration_tpu.data.video import Video as JaxVideo
from playablevideogeneration_tpu.data.video_dataset import VideoDataset as JaxVideoDataset
from playablevideogeneration_tpu_torch.config.configuration import (
    Configuration,
    EvaluationConfiguration,
)
from playablevideogeneration_tpu_torch.data import synthetic
from playablevideogeneration_tpu_torch.data.loader import DataLoader
from playablevideogeneration_tpu_torch.data.splitter import generate_splits
from playablevideogeneration_tpu_torch.data.transforms import make_train_transform
from playablevideogeneration_tpu_torch.data.video import Video
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_CONFIGS = ["01_bair.yaml", "02_breakout.yaml", "03_tennis.yaml"]


@pytest.mark.parametrize("name", RUN_CONFIGS)
def test_configuration_matches_jax(name):
    path = os.path.join(REPO, "configs", name)
    got, want = Configuration(path), JaxConfiguration(path)
    assert got.check_config(check_data_root=False) and want.check_config(check_data_root=False)
    assert got.get_config() == want.get_config()


@pytest.mark.parametrize("name", RUN_CONFIGS)
def test_evaluation_configuration_matches_jax(name):
    path = os.path.join(REPO, "configs", "evaluation", name)
    got, want = EvaluationConfiguration(path), JaxEvaluationConfiguration(path)
    got.check_config(check_data_root=False)
    want.check_config(check_data_root=False)
    assert got.get_config() == want.get_config()


def test_configuration_rejects_bad_splits():
    with open(os.path.join(REPO, "configs", "01_bair.yaml")) as f:
        config = yaml.safe_load(f)
    config["data"]["dataset_splits"] = [0.5, 0.4]
    with pytest.raises(ValueError, match="exactly 3"):
        Configuration(config=copy.deepcopy(config)).check_config(check_data_root=False)
    config["data"]["dataset_splits"] = [0.5, 0.4, 0.2]
    with pytest.raises(ValueError, match="sum to 1"):
        Configuration(config=config).check_config(check_data_root=False)


def test_chip_smoke_bair_config_is_the_yaml_but_its_overrides(tmp_path):
    """``chip_smoke.py`` builds BAIR's config as a dict (the card's machine
    has no PyYAML): it must be ``configs/01_bair.yaml``, and the loop phase's
    config the YAML's with exactly the listed overrides."""
    with open(os.path.join(REPO, "configs", "01_bair.yaml")) as f:
        want = yaml.safe_load(f)
    assert chip_smoke.BAIR_CONFIG == want
    root = str(tmp_path)
    for (section, key), value in {**chip_smoke.LOOP_OVERRIDES,
                                  **chip_smoke.loop_roots(root)}.items():
        assert key in want[section] and want[section][key] != value, (section, key)
        want[section][key] = value
    JaxConfiguration(config=want).check_config(check_data_root=False)
    for (section, key), value in chip_smoke.CHECKED_OVERRIDES.items():
        want[section][key] = value
    assert chip_smoke.loop_config(root) == want


@pytest.mark.parametrize("kwargs", [dict(length=6, seed=3),
                                    dict(length=5, height=40, width=56, actions_count=5,
                                         seed=8, square=6, step_pixels=4, fixed_y=7)])
def test_synthetic_video_matches_jax(kwargs):
    got = synthetic.make_moving_square_video(**kwargs)
    want = jax_synthetic.make_moving_square_video(**kwargs)
    assert got.get_frames_count() == want.get_frames_count()
    for i in range(got.get_frames_count()):
        frame = got.get_frame_at(i)
        assert frame.dtype == np.uint8
        np.testing.assert_array_equal(frame, np.asarray(want.get_frame_at(i)))
    for attr in ("actions", "rewards", "metadata", "dones"):
        assert getattr(got, attr) == getattr(want, attr), attr


def test_synthetic_config_matches_jax():
    kwargs = dict(data_root="/d", output_root="/o", height=32, width=40, actions_count=5,
                  batch_size=3, observations_count=7, observation_stacking=1,
                  hidden_state_size=8, state_features=12, pretraining_steps=4, max_steps=9,
                  action_space_dimension=1)
    assert synthetic.make_synthetic_config(**kwargs) == jax_synthetic.make_synthetic_config(
        **kwargs)


def test_video_files_are_read_alike_by_both_packages(tmp_path):
    """A video the port writes reads back the same in both packages, and so
    does one the JAX package writes; a missing pickle takes the same
    default in both."""
    video = synthetic.make_moving_square_video(length=6, height=24, width=24, seed=2)
    jax_synthetic.make_moving_square_video(length=6, height=24, width=24, seed=5).save(
        str(tmp_path / "jax"))
    video.save(str(tmp_path / "port"))
    os.remove(tmp_path / "port" / "rewards.pkl")
    for name in ("port", "jax"):
        got, want = Video().load(str(tmp_path / name)), JaxVideo().load(str(tmp_path / name))
        assert got.get_frames_count() == want.get_frames_count() == 6
        for i in range(6):
            np.testing.assert_array_equal(got.get_frame_at(i), np.asarray(want.get_frame_at(i)))
        for attr in ("actions", "rewards", "metadata", "dones"):
            assert getattr(got, attr) == getattr(want, attr), (name, attr)


# Dataset and loader: (observation_stacking, skip_frames, crop, target size).
DATASET_CASES = [
    pytest.param(1, 0, None, (32, 32), id="stack1-skip0"),
    pytest.param(2, 0, None, (32, 32), id="stack2-skip0"),
    pytest.param(1, 1, None, (32, 32), id="stack1-skip1"),
    pytest.param(2, 1, None, (32, 32), id="stack2-skip1"),
    pytest.param(2, 0, [3, 2, 31, 28], (20, 24), id="crop-resize"),
    pytest.param(1, 0, [4, 0, 28, 32], (24, 32), id="crop-only"),
]


def _datasets(path, stacking, skip, crop, size, observations_count=4, allowed=None):
    batching = {"observations_count": observations_count, "observation_stacking": stacking,
                "skip_frames": skip}
    return (VideoDataset(path, batching, make_train_transform(crop, size), allowed),
            JaxVideoDataset(path, batching, jax_transforms.make_train_transform(crop, size),
                            allowed))


def _assert_samples_equal(got, want):
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert a.observations.dtype == np.float32
        np.testing.assert_array_equal(a.observations, b.observations)
        for attr in ("actions", "rewards", "dones"):
            np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))
        assert a.initial_frame_index == b.initial_frame_index
        assert a.video.root == b.video.root


@pytest.mark.parametrize("stacking, skip, crop, size", DATASET_CASES)
def test_dataset_items_match_jax(synthetic_dataset_dir, stacking, skip, crop, size):
    got, want = _datasets(os.path.join(synthetic_dataset_dir, "train"), stacking, skip, crop,
                          size)
    _assert_samples_equal(got, want)
    assert got[-1].observations.shape == (4, size[1], size[0], 3 * stacking)


def test_crop_outside_the_frame_raises():
    transform = make_train_transform([0, 0, 40, 20], (20, 20))
    with pytest.raises(ValueError, match="crop"):
        transform(np.zeros((32, 32, 3), np.uint8))


def test_set_observations_count_matches_jax(synthetic_dataset_dir):
    got, want = _datasets(os.path.join(synthetic_dataset_dir, "train"), 2, 1, None, (32, 32))
    for count in (3, 6, 4):
        got.set_observations_count(count)
        want.set_observations_count(count)
        assert got.available_samples_list == want.available_samples_list
        assert len(got) == len(want)
    _assert_samples_equal(got, want)


def test_flat_split_matches_jax(tmp_path):
    root = str(tmp_path / "flat")
    synthetic.build_synthetic_dataset(root, videos_per_split=5, length=8, height=32, width=32,
                                      flat=True)
    with open(os.path.join(root, "README"), "w") as f:  # a stray file is no video
        f.write("not a video")
    config = synthetic.make_synthetic_config(data_root=root, output_root=str(tmp_path / "out"),
                                             height=32, width=32, observations_count=4)
    config["data"]["dataset_splits"] = [0.6, 0.2, 0.2]
    Configuration(config=config).check_config()
    got, want = generate_splits(config), jax_generate_splits(config)
    assert got == want
    for name, (path, batching, allowed) in got.items():
        stacking = batching["observation_stacking"]
        _assert_samples_equal(*_datasets(path, stacking, 0, None, (32, 32), allowed=allowed))


def test_in_memory_dataset_equals_the_one_on_disk(synthetic_dataset_dir):
    path = os.path.join(synthetic_dataset_dir, "val")
    batching = {"observations_count": 5, "observation_stacking": 2, "skip_frames": 0}
    transform = make_train_transform(None, (32, 32))
    on_disk = VideoDataset(path, batching, transform)
    videos = [Video().add_content([v.get_frame_at(i) for i in range(v.get_frames_count())],
                                  v.actions, v.rewards, v.metadata, v.dones)
              for v in on_disk.all_videos]
    in_memory = VideoDataset.from_videos(videos, batching, transform)
    assert len(in_memory) == len(on_disk)
    for i in range(len(on_disk)):
        np.testing.assert_array_equal(in_memory[i].observations, on_disk[i].observations)
        np.testing.assert_array_equal(in_memory[i].actions, on_disk[i].actions)


@pytest.mark.parametrize("mode, shards", [("thread", 1), ("process", 1), ("thread", 2)])
def test_loader_matches_jax(synthetic_dataset_dir, mode, shards):
    got_ds, want_ds = _datasets(os.path.join(synthetic_dataset_dir, "train"), 2, 0, None,
                                (32, 32))
    for shard in range(shards):
        kwargs = dict(batch_size=3, shuffle=True, drop_last=True, num_workers=2, seed=7,
                      worker_mode=mode, shard_index=shard, shard_count=shards)
        got_loader = DataLoader(got_ds, **kwargs)
        want_loader = JaxDataLoader(want_ds, **kwargs)
        assert len(got_loader) == len(want_loader) > 0
        for epoch in range(2):  # the shuffle moves on between epochs alike
            got, want = list(got_loader), list(want_loader)
            assert len(got) == len(want) == len(want_loader)
            for a, b in zip(got, want):
                assert a.initial_frames == b.initial_frames
                np.testing.assert_array_equal(a.observations, b.observations)
                np.testing.assert_array_equal(a.actions, b.actions)
                assert [v.root for v in a.videos] == [v.root for v in b.videos]


def test_package_data_ships_every_kernel_source():
    """An installed (non-editable) package must carry every file the kernel
    build reads: each file under ``ops/cuda/csrc`` matches a package-data
    glob of ``pyproject.toml``."""
    import fnmatch

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        package_data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    globs = package_data["playablevideogeneration_tpu_torch.ops.cuda"]
    csrc = os.path.join(REPO, "playablevideogeneration_tpu_torch", "ops", "cuda", "csrc")
    files = sorted(os.listdir(csrc))
    assert any(f.endswith(".cuh") for f in files) and any(f.endswith(".cu") for f in files)
    for name in files:
        assert any(fnmatch.fnmatch(f"csrc/{name}", g) for g in globs), name
