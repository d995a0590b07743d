"""Builds the evaluation dataset from a trained model.

Counterpart of ``playablevideogeneration_tpu/cli/build_evaluation_dataset.py``:
the run's ``latest`` checkpoint (or, with ``--reference-checkpoint``, a
reference ``.pth.tar``) reconstructs the config's test split, which is
written under the run's ``evaluation_dataset`` directory for
``cli.evaluate_dataset``.  GPU by default, ``--device cpu`` when asked:

    python -m playablevideogeneration_tpu_torch.cli.build_evaluation_dataset \\
        --config configs/01_bair.yaml
"""
from __future__ import annotations

import argparse
from typing import Optional

from playablevideogeneration_tpu_torch.cli.play import load_trained_model
from playablevideogeneration_tpu_torch.config import registry
from playablevideogeneration_tpu_torch.config.configuration import Configuration
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset
from playablevideogeneration_tpu_torch.utils.device import DeviceLike


def make_evaluation_dataset_builder(config_dict: dict, reference_checkpoint: Optional[str] = None,
                                    device: DeviceLike = "cuda",
                                    dataset: Optional[VideoDataset] = None):
    """The config's evaluation-dataset builder over the test split, with the
    trained model (``cli.play.load_trained_model``; ``dataset`` in place of
    the test split on disk)."""
    model, dataset, logger = load_trained_model(config_dict, "test", device, dataset,
                                                reference_checkpoint)
    return registry.resolve("builder", config_dict["evaluation_dataset"]["builder"])(
        config_dict, model, dataset, logger)


def build_evaluation_dataset(config_dict: dict, reference_checkpoint: Optional[str] = None,
                             device: DeviceLike = "cuda") -> str:
    """Builds and writes the evaluation dataset; returns its directory."""
    return make_evaluation_dataset_builder(config_dict, reference_checkpoint, device).build()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--reference-checkpoint", type=str, default=None,
                        help="import weights from a reference .pth.tar checkpoint instead "
                             "of the run's latest checkpoint")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run the model on (default: cuda)")
    args = parser.parse_args()
    configuration = Configuration(args.config)
    configuration.check_config()
    configuration.create_directory_structure()
    build_evaluation_dataset(configuration.get_config(),
                             reference_checkpoint=args.reference_checkpoint, device=args.device)


if __name__ == "__main__":
    main()
