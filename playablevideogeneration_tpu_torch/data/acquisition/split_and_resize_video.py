"""Splits a long source video into segments and resizes them, with ffmpeg.

Counterpart of
``playablevideogeneration_tpu/data/acquisition/split_and_resize_video.py``
(reference dataset/acquisition/split_and_resize_video.py).  ffmpeg and
ffprobe run as subprocesses; without them it raises.

Usage:
  python -m playablevideogeneration_tpu_torch.data.acquisition.split_and_resize_video \\
      --video_path in.mp4 --output_directory out --segment_seconds 3600 [--target_size W H]
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess


def probe_duration(video_path: str) -> float:
    """The video's duration in seconds, from ffprobe."""
    ffprobe = shutil.which("ffprobe")
    if ffprobe is None:
        raise RuntimeError("ffprobe is required but was not found")
    out = subprocess.run(
        [ffprobe, "-v", "error", "-show_entries", "format=duration",
         "-of", "default=noprint_wrappers=1:nokey=1", video_path],
        check=True, capture_output=True, text=True)
    return float(out.stdout.strip())


def split_and_resize(video_path: str, output_directory: str, segment_seconds: int = 3600,
                     target_size=None) -> None:
    """Segments of ``segment_seconds`` named after the source video
    (``<name>_00000.mp4`` ...), so that segments of several videos can
    share a directory and the annotation CSVs match them by name."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError("ffmpeg is required but was not found")
    os.makedirs(output_directory, exist_ok=True)
    cmd = [ffmpeg, "-y", "-i", video_path]
    if target_size is not None:
        cmd += ["-vf", f"scale={target_size[0]}:{target_size[1]}"]
    base = os.path.splitext(os.path.basename(video_path))[0]
    cmd += ["-f", "segment", "-segment_time", str(segment_seconds), "-reset_timestamps", "1",
            os.path.join(output_directory, f"{base}_%05d.mp4")]
    subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    print(f"Wrote {len(os.listdir(output_directory))} segments to {output_directory}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--video_path", required=True)
    parser.add_argument("--output_directory", required=True)
    parser.add_argument("--segment_seconds", type=int, default=3600)
    parser.add_argument("--target_size", type=int, nargs=2, default=None)
    args = parser.parse_args()
    split_and_resize(args.video_path, args.output_directory, args.segment_seconds,
                     args.target_size)


if __name__ == "__main__":
    main()
