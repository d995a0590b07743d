"""Converts annotated source videos (video files and CSV frame-range
annotations) into cropped sequences in the on-disk video dataset format.

Counterpart of
``playablevideogeneration_tpu/data/acquisition/convert_annotated_video_directory.py``
(reference dataset/acquisition/convert_annotated_video_directory.py), on
the port's ``Video``.  The frames are extracted with ffmpeg, which runs as
a subprocess; without it the conversion raises.

Annotation CSV rows: start_frame,end_frame,left,top,right,bottom

Usage:
  python -m playablevideogeneration_tpu_torch.data.acquisition.convert_annotated_video_directory \\
      --video_directory videos --annotations_directory csvs --output_directory out \\
      [--target_size W H]
"""
from __future__ import annotations

import argparse
import csv
import os
import shutil
import subprocess
import tempfile
from typing import List, Tuple

import numpy as np

from playablevideogeneration_tpu_torch.data.video import Video, pillow_image


def read_annotations(path: str) -> List[Tuple[int, int, Tuple[int, int, int, int]]]:
    """(start, end, (left, top, right, bottom)) per row of six or more
    fields; shorter rows are skipped."""
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if len(row) < 6:
                continue
            rows.append((int(row[0]), int(row[1]), tuple(int(v) for v in row[2:6])))
    return rows


def extract_frames(video_path: str, tmp_dir: str) -> List[str]:
    """Every frame of the video as a PNG in ``tmp_dir``, in order."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError("ffmpeg is required but was not found")
    subprocess.run([ffmpeg, "-y", "-i", video_path, os.path.join(tmp_dir, "%06d.png")],
                   check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return sorted(os.path.join(tmp_dir, f) for f in os.listdir(tmp_dir) if f.endswith(".png"))


def convert_annotated_video(video_path: str, annotations_path: str, output_directory: str,
                            start_index: int = 0, target_size=None) -> int:
    """One video's annotated ranges (end inclusive), cropped and resized
    with Pillow as the JAX package crops and resizes them, each written as
    ``output_directory/<index>`` from ``start_index``; returns the next
    index."""
    Image = pillow_image("converting annotated videos")
    annotations = read_annotations(annotations_path)
    out_idx = start_index
    with tempfile.TemporaryDirectory() as tmp:
        frame_files = extract_frames(video_path, tmp)
        for start, end, crop in annotations:
            frames = []
            for i in range(start, min(end + 1, len(frame_files))):
                with Image.open(frame_files[i]) as source:
                    image = source.convert("RGB").crop(crop)
                if target_size is not None:
                    image = image.resize(tuple(target_size), Image.BILINEAR)
                frames.append(np.asarray(image))
            if not frames:
                continue
            Video().add_content(frames, None, None, None, None).save(
                os.path.join(output_directory, f"{out_idx:05d}"))
            out_idx += 1
    return out_idx


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--video_directory", required=True)
    parser.add_argument("--annotations_directory", required=True)
    parser.add_argument("--output_directory", required=True)
    parser.add_argument("--target_size", type=int, nargs=2, default=None)
    args = parser.parse_args()

    os.makedirs(args.output_directory, exist_ok=True)
    idx = 0
    for name in sorted(os.listdir(args.video_directory)):
        annotation = os.path.join(args.annotations_directory,
                                  os.path.splitext(name)[0] + ".csv")
        if not os.path.isfile(annotation):
            continue
        idx = convert_annotated_video(os.path.join(args.video_directory, name), annotation,
                                      args.output_directory, idx, args.target_size)
    print(f"Wrote {idx} annotated sequences to {args.output_directory}")


if __name__ == "__main__":
    main()
