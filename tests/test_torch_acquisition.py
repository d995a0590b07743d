"""The port's data acquisition CLIs, augmentation transform and
``Video.subsample_split_resize`` against the JAX package's, on the CPU.

The CLIs write their output trees from the same inputs in both packages,
and the trees must match byte for byte.  The three that run ffmpeg (or
ffprobe) run with fake tools placed first on ``PATH``: the fake ffmpeg logs
its arguments and writes numbered PNG frames (seeded by the input's name)
or segment files, the fake ffprobe prints a duration.  Both packages must
issue the same commands, and raise the same error without the tools.
"""
import json
import os
import random
import sys

import numpy as np
import pytest
from PIL import Image
from torch_parity import single_threaded_torch  # noqa: F401 (an autouse fixture)

from playablevideogeneration_tpu.data import transforms as jax_transforms
from playablevideogeneration_tpu.data.acquisition import (
    convert_annotated_video_directory as jax_annotated,
)
from playablevideogeneration_tpu.data.acquisition import convert_video_directory as jax_convert
from playablevideogeneration_tpu.data.acquisition import shift_video_ids as jax_shift
from playablevideogeneration_tpu.data.acquisition import split_and_resize_video as jax_split
from playablevideogeneration_tpu.data.acquisition import (
    subsample_videos_and_make_fixed_length as jax_subsample,
)
from playablevideogeneration_tpu.data.acquisition import train_val_test_split as jax_tvt
from playablevideogeneration_tpu.data.video import Video as JaxVideo
from playablevideogeneration_tpu_torch.data import transforms
from playablevideogeneration_tpu_torch.data.acquisition import (
    convert_annotated_video_directory as port_annotated,
)
from playablevideogeneration_tpu_torch.data.acquisition import (
    convert_video_directory as port_convert,
)
from playablevideogeneration_tpu_torch.data.acquisition import shift_video_ids as port_shift
from playablevideogeneration_tpu_torch.data.acquisition import (
    split_and_resize_video as port_split,
)
from playablevideogeneration_tpu_torch.data.acquisition import (
    subsample_videos_and_make_fixed_length as port_subsample,
)
from playablevideogeneration_tpu_torch.data.acquisition import train_val_test_split as port_tvt
from playablevideogeneration_tpu_torch.data.video import Video

FAKE_FFMPEG = """
import json, os, sys, zlib
import numpy as np
from PIL import Image
args = sys.argv[1:]
with open(os.environ["FAKE_TOOL_LOG"], "a") as f:
    f.write(json.dumps(["ffmpeg"] + args) + "\\n")
out = args[-1]
rng = np.random.default_rng(zlib.crc32(os.path.basename(args[args.index("-i") + 1]).encode()))
width, height = 40, 30
if "-vf" in args:
    width, height = map(int, args[args.index("-vf") + 1][len("scale="):].split(":"))
if out.endswith(".png"):
    for i in range(1, 8):  # ffmpeg numbers frames from 1
        frame = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        Image.fromarray(frame).save(out % i)
else:
    for i in range(3):
        with open(out % i, "wb") as f:
            f.write(rng.bytes(64))
"""
FAKE_FFPROBE = """
import json, os, sys
with open(os.environ["FAKE_TOOL_LOG"], "a") as f:
    f.write(json.dumps(["ffprobe"] + sys.argv[1:]) + "\\n")
print("12.5")
"""


def tree(root: str) -> dict:
    """Every file under ``root`` by relative path, with its bytes."""
    files = {}
    for directory, _, names in os.walk(root):
        for name in names:
            path = os.path.join(directory, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, root)] = f.read()
    return files


def assert_same_tree(got: str, want: str) -> None:
    got, want = tree(got), tree(want)
    assert want and sorted(got) == sorted(want)
    for name, content in want.items():
        assert got[name] == content, name


@pytest.fixture
def fake_tools(tmp_path, monkeypatch):
    """Fake ffmpeg and ffprobe first on PATH; returns a function that reads
    and clears their logged commands, with ``out`` replaced by ``<out>`` and
    temporary frame directories dropped."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name, body in (("ffmpeg", FAKE_FFMPEG), ("ffprobe", FAKE_FFPROBE)):
        path = bin_dir / name
        path.write_text(f"#!{sys.executable}\n{body}")
        path.chmod(0o755)
    log = tmp_path / "tools.log"
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_TOOL_LOG", str(log))

    def commands(out: str) -> list:
        lines = log.read_text().splitlines() if log.exists() else []
        log.unlink(missing_ok=True)
        return [[os.path.basename(a) if a.endswith(".png") else a.replace(out, "<out>")
                 for a in json.loads(line)] for line in lines]

    return commands


def _videos(directory: str, count: int = 2) -> None:
    os.makedirs(directory)
    for i in range(count):
        with open(os.path.join(directory, f"clip{i}.mp4"), "wb") as f:
            f.write(b"not a real video")


@pytest.mark.parametrize("target_size", [None, (24, 20)], ids=["native", "resized"])
def test_convert_video_directory_matches_jax(tmp_path, fake_tools, target_size):
    _videos(str(tmp_path / "videos"))
    issued = {}
    for name, module in (("jax", jax_convert), ("port", port_convert)):
        out = str(tmp_path / name)
        module.convert_video_directory(str(tmp_path / "videos"), out, processes=1,
                                       target_size=target_size)
        issued[name] = fake_tools(out)
    assert len(issued["port"]) == 2 and issued["port"] == issued["jax"]
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_convert_annotated_video_directory_matches_jax(tmp_path, fake_tools):
    _videos(str(tmp_path / "videos"), count=1)
    annotations = tmp_path / "clip0.csv"
    annotations.write_text("1,3,2,4,30,26\nshort,row\n5,9,0,0,40,30\n9,12,3,3,10,10\n")
    issued = {}
    for name, module in (("jax", jax_annotated), ("port", port_annotated)):
        out = str(tmp_path / name)
        os.makedirs(out)
        next_index = module.convert_annotated_video(
            str(tmp_path / "videos" / "clip0.mp4"), str(annotations), out, start_index=3,
            target_size=(16, 12))
        assert next_index == 5  # the third range starts past the 7 frames
        issued[name] = fake_tools(out)
    assert port_annotated.read_annotations(str(annotations)) == jax_annotated.read_annotations(
        str(annotations))
    assert issued["port"] == issued["jax"]
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_split_and_resize_video_matches_jax(tmp_path, fake_tools):
    _videos(str(tmp_path / "videos"), count=1)
    video = str(tmp_path / "videos" / "clip0.mp4")
    issued = {}
    for name, module in (("jax", jax_split), ("port", port_split)):
        out = str(tmp_path / name)
        module.split_and_resize(video, out, segment_seconds=600, target_size=(64, 48))
        assert module.probe_duration(video) == 12.5
        issued[name] = fake_tools(out)
    assert issued["port"] == issued["jax"] and [c[0] for c in issued["port"]] == [
        "ffmpeg", "ffprobe"]
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_acquisition_raises_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    _videos(str(tmp_path / "videos"), count=1)
    video = str(tmp_path / "videos" / "clip0.mp4")
    for jax_call, port_call in (
            (lambda: jax_convert.convert_one((video, str(tmp_path / "a"), None)),
             lambda: port_convert.convert_one((video, str(tmp_path / "a"), None))),
            (lambda: jax_annotated.extract_frames(video, str(tmp_path)),
             lambda: port_annotated.extract_frames(video, str(tmp_path))),
            (lambda: jax_split.split_and_resize(video, str(tmp_path / "b")),
             lambda: port_split.split_and_resize(video, str(tmp_path / "b"))),
            (lambda: jax_split.probe_duration(video), lambda: port_split.probe_duration(video))):
        with pytest.raises(RuntimeError) as want:
            jax_call()
        with pytest.raises(RuntimeError, match=str(want.value)):
            port_call()


@pytest.mark.parametrize("target_size", [None, (24, 20)], ids=["native", "resized"])
def test_subsample_and_split_matches_jax(synthetic_dataset_dir, tmp_path, target_size):
    source = os.path.join(synthetic_dataset_dir, "train")
    for name, module in (("jax", jax_subsample), ("port", port_subsample)):
        module.subsample_and_split(source, str(tmp_path / name), frame_skip=1,
                                   sequence_length=3, target_size=target_size)
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_train_val_test_split_matches_jax(synthetic_dataset_dir, tmp_path):
    source = os.path.join(synthetic_dataset_dir, "train")
    splits = tmp_path / "splits.csv"
    splits.write_text("00001,train\n00000,test\nmissing,val\n\n00000,train\n")
    for name, module in (("jax", jax_tvt), ("port", port_tvt)):
        module.train_val_test_split(source, str(tmp_path / name), str(splits))
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    splits.write_text("00000,holdout\n")
    for module in (jax_tvt, port_tvt):
        with pytest.raises(ValueError, match="Unknown split 'holdout'"):
            module.train_val_test_split(source, str(tmp_path / "bad"), str(splits))


@pytest.mark.parametrize("offset", [3, -1])
def test_shift_video_ids_matches_jax(tmp_path, offset):
    for name, module in (("jax", jax_shift), ("port", port_shift)):
        root = tmp_path / name
        for entry in ("00001", "00002", "00003", "notes"):
            (root / entry).mkdir(parents=True)
            (root / entry / "tag.txt").write_text(entry)
        (root / "00009.txt").write_text("a file, not a video")
        module.shift_video_ids(str(root), offset)
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port"))[0] == f"{1 + offset:05d}"


def test_augmentation_transform_matches_jax():
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    config = {"rotation_range": (-20.0, 20.0), "translation_range": (-4.0, 4.0),
              "scale_range": (0.8, 1.2)}
    for seed in range(4):
        want = jax_transforms.sample_augmentation_transform(config, random.Random(seed))
        got = transforms.sample_augmentation_transform(config, random.Random(seed))
        np.testing.assert_array_equal(got(frame), np.asarray(want(Image.fromarray(frame))))
    np.testing.assert_array_equal(transforms.to_array(frame),
                                  jax_transforms.to_array(Image.fromarray(frame)))


@pytest.mark.parametrize("target_size", [None, (20, 16), (40, 30)],
                         ids=["native", "resized", "same_size"])
def test_subsample_split_resize_matches_jax(target_size):
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (30, 40, 3), dtype=np.uint8) for _ in range(11)]
    lists = (list(range(11)), [0.5 * i for i in range(11)], [{"i": i} for i in range(11)],
             [i == 10 for i in range(11)])
    want = JaxVideo().add_content(frames, *lists).subsample_split_resize(1, 2, target_size)
    got = Video().add_content(frames, *lists).subsample_split_resize(1, 2, target_size)
    assert len(got) == len(want) == 3  # frames 0, 2, ..., 10 in clips of 2
    for g, w in zip(got, want):
        assert (g.actions, g.rewards, g.metadata, g.dones) == (
            w.actions, w.rewards, w.metadata, w.dones)
        for i in range(w.get_frames_count()):
            np.testing.assert_array_equal(g.get_frame_at(i), np.asarray(w.get_frame_at(i)))
