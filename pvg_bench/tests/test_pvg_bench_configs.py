"""The configurations' JSON copies against the YAML configs their sources
name, and every file that BENCHMARK.json's names lead to."""
import json
import os
import re

import pytest
import yaml

from pvg_bench import drive, spec

CONFIGS = {c["name"]: c for c in spec.benchmark()["configs"]}


def named_yaml(source: str):
    """The YAML under ``configs/`` that ``source`` names, where there is one."""
    match = re.search(r"(?<![\w.-])configs/[\w.-]+\.ya?ml\b", source)
    path = match and os.path.join(spec.ROOT, match.group(0))
    return path if path and os.path.isfile(path) else None


def test_named_yaml():
    assert named_yaml(CONFIGS["bair"]["source"]) == os.path.join(spec.ROOT,
                                                                 "configs/01_bair.yaml")
    assert named_yaml("https://github.com/pytorch/vision/blob/main/torchvision/models/"
                      "detection/faster_rcnn.py") is None
    assert named_yaml("configs/no_such_config.yaml") is None


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_json_is_the_yaml(name):
    with open(os.path.join(spec.ROOT, CONFIGS[name]["file"])) as f:
        described = json.load(f)
    assert set(spec.DESCRIPTION_KEYS) <= set(described)
    path = named_yaml(CONFIGS[name]["source"])
    if path is not None:
        with open(path) as f:
            assert spec.program_config(name) == yaml.safe_load(f)


def test_benchmark_names_lead_to_files():
    bench = spec.benchmark()
    for config in bench["configs"]:
        with open(os.path.join(spec.ROOT, config["file"])) as f:
            described = json.load(f)
        assert described["reduced"] == config["reduced"]
        assert described["source"]
    for entry in bench["workloads"]:
        cell = spec.cell(entry["name"], 1, 1.0, False, None, bench)
        assert callable(drive.load_driver(cell.traffic["driver"]))
        reported = {m["name"] for m in spec.metrics_of(bench, "end_to_end", entry["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_of(bench, "per_layer", entry["name"])
    for metric in bench["per_layer"]:
        assert os.path.isfile(os.path.join(spec.PACKAGE, "layer_metrics", metric["name"] + ".py"))
