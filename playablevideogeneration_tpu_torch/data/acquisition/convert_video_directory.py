"""Converts a directory of video files into the on-disk video dataset
format, extracting the frames with ffmpeg.

Counterpart of
``playablevideogeneration_tpu/data/acquisition/convert_video_directory.py``
(reference dataset/acquisition/convert_video_directory.py), on the port's
``Video``: the same ffmpeg command per video, the same output tree.
ffmpeg runs as a subprocess; without it the conversion raises.

Usage:
  python -m playablevideogeneration_tpu_torch.data.acquisition.convert_video_directory \\
      --video_directory in_dir --output_directory out_dir [--processes 4] [--extension mp4]
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from playablevideogeneration_tpu_torch.data.video import Video, pillow_image


def read_rgb(path: str) -> np.ndarray:
    """An image file as an (H, W, 3) uint8 array, through Pillow's RGB
    conversion (as the JAX package reads extracted frames)."""
    with pillow_image(f"reading {path}").open(path) as image:
        return np.asarray(image.convert("RGB"))


def convert_one(task) -> str:
    """(video path, output video directory, target size or None) -> the
    output directory, written."""
    video_path, output_path, target_size = task
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError("ffmpeg is required for video conversion but was not found")
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [ffmpeg, "-y", "-i", video_path]
        if target_size is not None:
            cmd += ["-vf", f"scale={target_size[0]}:{target_size[1]}"]
        cmd += [os.path.join(tmp, "%05d.png")]
        subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        files = sorted(f for f in os.listdir(tmp) if f.endswith(".png"))
        frames = [read_rgb(os.path.join(tmp, f)) for f in files]
        Video().add_content(frames, None, None, None, None).save(output_path)
    return output_path


def convert_video_directory(video_directory: str, output_directory: str, processes: int = 4,
                            extension: str = "mp4", target_size=None) -> None:
    """Every ``*.<extension>`` in ``video_directory``, in name order, into
    ``output_directory/00000`` on; ``processes`` above 1 converts in a pool
    of spawned processes."""
    os.makedirs(output_directory, exist_ok=True)
    videos = sorted(f for f in os.listdir(video_directory) if f.endswith("." + extension))
    tasks = [(os.path.join(video_directory, name),
              os.path.join(output_directory, f"{idx:05d}"), target_size)
             for idx, name in enumerate(videos)]
    if processes <= 1:
        for task in tasks:
            convert_one(task)
    else:
        with ProcessPoolExecutor(max_workers=processes,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(convert_one, tasks))
    print(f"Converted {len(tasks)} videos to {output_directory}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--video_directory", required=True)
    parser.add_argument("--output_directory", required=True)
    parser.add_argument("--processes", type=int, default=4)
    parser.add_argument("--extension", default="mp4")
    parser.add_argument("--target_size", type=int, nargs=2, default=None)
    args = parser.parse_args()
    convert_video_directory(args.video_directory, args.output_directory, args.processes,
                            args.extension, args.target_size)


if __name__ == "__main__":
    main()
