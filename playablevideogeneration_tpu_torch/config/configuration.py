"""YAML run configuration.

Counterpart of ``playablevideogeneration_tpu/config/configuration.py``:
the same schema (the reference's ``configs/*.yaml``), the same defaults
and derived paths, key for key, including the ``tpu:`` block.  Of that
block the port reads ``compute_dtype``, ``remat``, ``grad_histograms``,
``profile_dir`` and ``prefetch_batches``; its other keys choose TPU
layouts and are kept only so that a checked configuration is the same dict
in both packages.

PyYAML is imported only when a file is read, so a configuration built as
a dict needs no YAML installation.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional


def _load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


class Configuration:
    """Loads, validates and completes a run configuration."""

    def __init__(self, path: Optional[str] = None, config: Optional[Dict] = None):
        self.config: Dict[str, Any] = _load_yaml(path) if config is None else config

    def get_config(self) -> Dict[str, Any]:
        return self.config

    def check_config(self, check_data_root: bool = True) -> bool:
        """Validates the configuration and adds the defaults and the derived
        output paths."""
        c = self.config

        if check_data_root and not os.path.isdir(c["data"]["data_root"]):
            raise ValueError(f"Data directory {c['data']['data_root']} does not exist")

        log = c["logging"]
        log["output_directory"] = os.path.join(log["output_root"], log["run_name"])
        log["save_root_directory"] = os.path.join(log["save_root"], log["run_name"])
        log["output_images_directory"] = os.path.join(log["output_directory"], "images")
        log["amt_sequences"] = os.path.join(log["output_directory"], "amt_sequences")
        log["interpolated_sequences"] = os.path.join(log["output_directory"],
                                                     "interpolated_sequences")
        log["evaluation_dataset_directory"] = os.path.join(log["output_directory"],
                                                           "evaluation_dataset")
        log["evaluation_images_directory"] = os.path.join(log["output_directory"],
                                                          "evaluation_images")

        # A flat directory with fractional splits, or train/ val/ test/
        # subdirectories.
        if "dataset_splits" not in c["data"]:
            c["data"]["dataset_style"] = "splitted"
        else:
            c["data"]["dataset_style"] = "flat"
            if len(c["data"]["dataset_splits"]) != 3:
                raise ValueError("Dataset splits must specify exactly 3 elements")
            if abs(sum(c["data"]["dataset_splits"]) - 1.0) > 1e-6:
                raise ValueError("Dataset splits must sum to 1.0")

        c["data"].setdefault("crop", None)
        c["evaluation"].setdefault("eval_freq", 0)
        c["training"].setdefault("use_motion_weights", False)
        c["training"].setdefault("motion_weights_bias", 0.0)
        c["data"].setdefault("ground_truth_available", True)
        c["training"].setdefault("action_direction_plotting_freq", 1000)
        c["training"].setdefault("action_mutual_information_entropy_lambda", 1.0)
        c["evaluation"].setdefault("max_evaluation_batches", None)
        c["training"].setdefault("max_steps_per_epoch", 10000)
        c["model"]["action_network"].setdefault("use_variations", True)

        # An empty `tpu:` block parses as None.
        if c.get("tpu") is None:
            c["tpu"] = {}
        c["tpu"].setdefault("compute_dtype", "float32")
        c["tpu"].setdefault("data_parallel_devices", None)
        c["tpu"].setdefault("model_parallel", 1)
        c["tpu"].setdefault("tp_min_channels", 256)
        c["tpu"].setdefault("donate_state", True)
        c["tpu"].setdefault("prefetch_batches", 2)
        c["tpu"].setdefault("remat", False)
        c["tpu"].setdefault("pretrained_weights_dir", None)
        c["tpu"].setdefault("pretrained_weights", {})

        if c["training"]["use_ground_truth_actions"] and not c["data"]["ground_truth_available"]:
            raise ValueError(
                "Requested to use ground truth data, but no annotations are present in the dataset"
            )

        return True

    def create_directory_structure(self):
        log = self.config["logging"]
        for key in ("output_directory", "save_root_directory", "output_images_directory",
                    "amt_sequences", "interpolated_sequences", "evaluation_dataset_directory",
                    "evaluation_images_directory"):
            Path(log[key]).mkdir(parents=True, exist_ok=True)


class EvaluationConfiguration:
    """Configuration of the offline evaluation pipeline: a reference (ground
    truth) dataset paired with a generated one."""

    def __init__(self, path: Optional[str] = None, config: Optional[Dict] = None):
        self.config: Dict[str, Any] = _load_yaml(path) if config is None else config

    def get_config(self) -> Dict[str, Any]:
        return self.config

    def check_config(self, check_data_root: bool = True) -> bool:
        c = self.config
        for key in ("reference_data", "generated_data"):
            if check_data_root and not os.path.isdir(c[key]["data_root"]):
                raise ValueError(f"Data directory {c[key]['data_root']} does not exist")
            c[key].setdefault("crop", None)

        log = c["logging"]
        log["output_directory"] = os.path.join(log["output_root"], log["run_name"])
        c["evaluation"].setdefault("max_evaluation_batches", None)
        c["evaluation"].setdefault("detector", "none")
        # Off by default: the reference constructs the Inception Score but
        # leaves it out of the metric run.
        c["evaluation"].setdefault("compute_inception_score", False)
        c.setdefault("tpu", {})
        c["tpu"].setdefault("pretrained_weights_dir", None)
        c["tpu"].setdefault("pretrained_weights", {})
        return True

    def create_directory_structure(self):
        Path(self.config["logging"]["output_directory"]).mkdir(parents=True, exist_ok=True)
