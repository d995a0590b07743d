"""Subsamples a dataset's videos and cuts them into fixed-length clips,
the format of the evaluation sets.

Counterpart of
``playablevideogeneration_tpu/data/acquisition/subsample_videos_and_make_fixed_length.py``
(reference dataset/acquisition/subsample_videos_and_make_fixed_length.py:
16-frame tennis clips with frame_skip 4).

Usage:
  python -m playablevideogeneration_tpu_torch.data.acquisition.subsample_videos_and_make_fixed_length \\
      --input_directory data/x/test --output_directory data/x/fixed_test \\
      --frame_skip 4 --sequence_length 16
"""
from __future__ import annotations

import argparse
import os

from playablevideogeneration_tpu_torch.data.video import Video


def subsample_and_split(input_directory: str, output_directory: str, frame_skip: int,
                        sequence_length: int, target_size=None) -> None:
    """Every video directory of ``input_directory``, in name order, through
    ``Video.subsample_split_resize``; the clips numbered from 00000."""
    os.makedirs(output_directory, exist_ok=True)
    out_idx = 0
    for name in sorted(os.listdir(input_directory)):
        path = os.path.join(input_directory, name)
        if not os.path.isdir(path):
            continue
        for chunk in Video().load(path).subsample_split_resize(frame_skip, sequence_length,
                                                               target_size):
            chunk.save(os.path.join(output_directory, f"{out_idx:05d}"))
            out_idx += 1
    print(f"Wrote {out_idx} fixed-length sequences to {output_directory}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_directory", required=True)
    parser.add_argument("--output_directory", required=True)
    parser.add_argument("--frame_skip", type=int, default=4)
    parser.add_argument("--sequence_length", type=int, default=16)
    parser.add_argument("--target_size", type=int, nargs=2, default=None)
    args = parser.parse_args()
    subsample_and_split(args.input_directory, args.output_directory, args.frame_skip,
                        args.sequence_length, args.target_size)


if __name__ == "__main__":
    main()
