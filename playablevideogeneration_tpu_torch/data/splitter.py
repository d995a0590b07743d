"""Dataset splits: pre-split directories or fractional flat splits.

Counterpart of ``playablevideogeneration_tpu/data/splitter.py``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Set, Tuple


def generate_splits(config) -> Dict[str, Tuple[str, dict, Optional[Set[str]]]]:
    """{"train" | "validation" | "test": (path, batching config, allowed
    video names or None)} for the config's dataset style."""
    style = config["data"]["dataset_style"]
    root = config["data"]["data_root"]

    if style == "flat":
        # Directories only: a stray file would shift every fraction boundary.
        contents = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        fractions = config["data"]["dataset_splits"]
        n = len(contents)
        n_train = int(n * fractions[0])
        n_val = int(n * fractions[1])
        return {
            "train": (root, config["training"]["batching"], set(contents[:n_train])),
            "validation": (root, config["evaluation"]["batching"],
                           set(contents[n_train:n_train + n_val])),
            "test": (root, config["evaluation"]["batching"], set(contents[n_train + n_val:])),
        }
    if style == "splitted":
        return {
            "train": (os.path.join(root, "train"), config["training"]["batching"], None),
            "validation": (os.path.join(root, "val"), config["evaluation"]["batching"], None),
            "test": (os.path.join(root, "test"), config["evaluation"]["batching"], None),
        }
    raise ValueError(f"Unknown dataset style '{style}'")
