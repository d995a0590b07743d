"""Renumbers a directory's video directories by an offset.

Counterpart of ``playablevideogeneration_tpu/data/acquisition/shift_video_ids.py``
(reference dataset/acquisition/shift_video_ids.py).

Usage:
  python -m playablevideogeneration_tpu_torch.data.acquisition.shift_video_ids \\
      --directory data/x/train --offset 100
"""
from __future__ import annotations

import argparse
import os


def shift_video_ids(directory: str, offset: int) -> None:
    """Renames every all-digit directory ``n`` to ``n + offset`` (five
    digits), from the highest first for a positive offset, so that no
    rename lands on a name not yet moved."""
    names = sorted((n for n in os.listdir(directory)
                    if os.path.isdir(os.path.join(directory, n)) and n.isdigit()),
                   key=int, reverse=offset > 0)
    for name in names:
        os.rename(os.path.join(directory, name),
                  os.path.join(directory, f"{int(name) + offset:05d}"))
    print(f"Shifted {len(names)} videos by {offset}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--directory", required=True)
    parser.add_argument("--offset", type=int, required=True)
    args = parser.parse_args()
    shift_video_ids(args.directory, args.offset)


if __name__ == "__main__":
    main()
