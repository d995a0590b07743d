"""Splits a directory of videos into train/, val/ and test/ by a CSV.

Counterpart of
``playablevideogeneration_tpu/data/acquisition/train_val_test_split.py``
(reference dataset/acquisition/train_val_test_split.py): each row
``video_name,split`` copies that video directory into the split, numbered
from 00000 in row order.

Usage:
  python -m playablevideogeneration_tpu_torch.data.acquisition.train_val_test_split \\
      --input_directory data/x/all --output_directory data/x --splits_csv splits.csv
"""
from __future__ import annotations

import argparse
import csv
import os
import shutil


def train_val_test_split(input_directory: str, output_directory: str,
                         splits_csv: str) -> None:
    """Copies the CSV's videos into their splits; an unknown split raises,
    a missing video is skipped with a message."""
    counters = {"train": 0, "val": 0, "test": 0}
    with open(splits_csv) as f:
        for row in csv.reader(f):
            if len(row) < 2:
                continue
            name, split = row[0].strip(), row[1].strip()
            if split not in counters:
                raise ValueError(f"Unknown split '{split}' for video '{name}'")
            src = os.path.join(input_directory, name)
            if not os.path.isdir(src):
                print(f"- Skipping missing video '{name}'")
                continue
            dst_dir = os.path.join(output_directory, split)
            os.makedirs(dst_dir, exist_ok=True)
            shutil.copytree(src, os.path.join(dst_dir, f"{counters[split]:05d}"))
            counters[split] += 1
    print(f"Split complete: {counters}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_directory", required=True)
    parser.add_argument("--output_directory", required=True)
    parser.add_argument("--splits_csv", required=True)
    args = parser.parse_args()
    train_val_test_split(args.input_directory, args.output_directory, args.splits_csv)


if __name__ == "__main__":
    main()
