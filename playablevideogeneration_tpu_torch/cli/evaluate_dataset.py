"""Offline metrics over a (reference, generated) dataset pair.

Counterpart of ``playablevideogeneration_tpu/cli/evaluate_dataset.py``:
the evaluation config's reference split against the videos that
``cli.build_evaluation_dataset`` wrote, through the config's dataset
evaluator; the metrics go to ``data.yml`` in the run's output directory.
GPU by default, ``--device cpu`` when asked:

    python -m playablevideogeneration_tpu_torch.cli.evaluate_dataset \\
        --config configs/evaluation/01_bair.yaml

``data.yml`` is written by a small emitter of its own (PyYAML is not
needed): ``yaml.safe_load`` reads it back as the same dict that the JAX
package's ``yaml.safe_dump`` writes, NaN and infinities included.
"""
from __future__ import annotations

import argparse
import json
import math
import numbers
import os
from typing import Dict, Optional, Tuple

from playablevideogeneration_tpu_torch.config import registry
from playablevideogeneration_tpu_torch.config.configuration import EvaluationConfiguration
from playablevideogeneration_tpu_torch.data.transforms import get_evaluation_transforms
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset
from playablevideogeneration_tpu_torch.utils import pretrained
from playablevideogeneration_tpu_torch.utils.device import DeviceLike, resolve_device
from playablevideogeneration_tpu_torch.utils.logging import Logger


def _yaml_value(value) -> str:
    """A flow-style YAML 1.1 scalar or sequence of one metric value: a
    string, an integer, a float or a (nested) list of them."""
    if isinstance(value, str):
        return json.dumps(value)  # a valid YAML double-quoted scalar
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_yaml_value(v) for v in value) + "]"
    if isinstance(value, bool):
        raise TypeError("no metric is a boolean")
    if isinstance(value, numbers.Integral):
        return str(int(value))
    value = float(value)
    if math.isnan(value):
        return ".nan"
    if math.isinf(value):
        return ".inf" if value > 0 else "-.inf"
    # YAML 1.1 reads a float only with a '.' in the mantissa and a signed
    # exponent: repr's '1e-05' would read back as a string.
    mantissa, _, exponent = repr(value).partition("e")
    if "." not in mantissa:
        mantissa += ".0"
    if exponent and exponent[0] not in "+-":
        exponent = "+" + exponent
    return mantissa + ("e" + exponent if exponent else "")


def write_metrics_yaml(metrics: Dict, path: str) -> None:
    """Writes the metrics as a YAML mapping, one key per line."""
    with open(path, "w") as f:
        for key in sorted(metrics):
            f.write(f"{json.dumps(str(key))}: {_yaml_value(metrics[key])}\n")


def evaluate_dataset(config_dict: dict, device: DeviceLike = "cuda",
                     datasets: Optional[Tuple[VideoDataset, VideoDataset]] = None,
                     **backbones) -> Dict:
    """Computes the metrics, writes ``data.yml`` and returns the metrics.

    :param datasets: the (reference, generated) ``VideoDataset`` pair in
        place of the config's data roots (videos held in memory, frames in
        [0, 1])
    :param backbones: the dataset evaluator's ``vgg_variables`` or
        ``lpips_fn`` in place of the ones found from the config
    """
    registry._register_defaults()
    logger = Logger(config_dict)
    device = resolve_device(device)
    if datasets is None:
        ref_transform, gen_transform = get_evaluation_transforms(config_dict)
        batching = config_dict["evaluation"]["batching"]
        datasets = (
            VideoDataset(config_dict["reference_data"]["data_root"], batching, ref_transform),
            VideoDataset(config_dict["generated_data"]["data_root"], batching, gen_transform))
    found = pretrained.evaluation_backbones(config_dict, logger, device)
    found.update(backbones)
    evaluator = registry.resolve("dataset_evaluator", config_dict["evaluation"]["evaluator"])(
        config_dict, logger, *datasets, device=device, **found)
    metrics = evaluator.compute_metrics()

    output_dir = config_dict["logging"]["output_directory"]
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, "data.yml")
    write_metrics_yaml(metrics, out_path)
    logger.print(f"- Wrote metrics to {out_path}")
    return metrics


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to compute the frame metrics on (default: cuda)")
    args = parser.parse_args()
    configuration = EvaluationConfiguration(args.config)
    configuration.check_config()
    configuration.create_directory_structure()
    evaluate_dataset(configuration.get_config(), device=args.device)


if __name__ == "__main__":
    main()
