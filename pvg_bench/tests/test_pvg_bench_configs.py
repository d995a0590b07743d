"""The configurations' JSON copies against the YAML configs, and every file
that BENCHMARK.json's names lead to."""
import json
import os

import pytest
import yaml

from pvg_bench import spec

YAML = {"bair": "configs/01_bair.yaml", "tennis": "configs/03_tennis.yaml"}


@pytest.mark.parametrize("name", sorted(YAML))
def test_config_json_is_the_yaml(name):
    with open(os.path.join(spec.ROOT, YAML[name])) as f:
        want = yaml.safe_load(f)
    assert spec.program_config(name) == want


def test_benchmark_names_lead_to_files():
    bench = spec.benchmark()
    for config in bench["configs"]:
        with open(os.path.join(spec.ROOT, config["file"])) as f:
            described = json.load(f)
        assert described["reduced"] == config["reduced"]
        assert described["source"]
    for entry in bench["workloads"]:
        cell = spec.cell(entry["name"], 1, 1.0, False, None, bench)
        assert cell.traffic["driver"] in ("train", "interactive", "rollout")
        reported = {m["name"] for m in spec.metrics_of(bench, "end_to_end", entry["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_of(bench, "per_layer", entry["name"])
    for metric in bench["per_layer"]:
        assert os.path.isfile(os.path.join(spec.PACKAGE, "layer_metrics", metric["name"] + ".py"))
