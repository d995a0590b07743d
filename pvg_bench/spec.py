"""The benchmark's definition: ``BENCHMARK.json`` at the checkout's root and
the data files it names under ``pvg_bench/`` (a configuration's file, a
traffic mix's and a cell's limits), found by name."""
from __future__ import annotations

import json
import os
from typing import List

import torch

from pvg_bench.drive import Cell

PACKAGE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE)
# Keys of a configuration's file that describe it and that the program
# does not read.
DESCRIPTION_KEYS = ("source", "reduced", "assumed")


def _json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT, "BENCHMARK.json")


def workload(name: str, spec: dict = None) -> dict:
    spec = spec or benchmark()
    for entry in spec["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def program_config(name: str) -> dict:
    config = _json(PACKAGE, "configs", f"{name}.json")
    return {k: v for k, v in config.items() if k not in DESCRIPTION_KEYS}


def traffic(name: str) -> dict:
    return _json(PACKAGE, "traffic", f"{name}.json")


def limits(workload_name: str) -> dict:
    return _json(PACKAGE, "limits", f"{workload_name}.json")


def metrics_of(spec: dict, kind: str, workload_name: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that the cell reports."""
    return [m for m in spec[kind] if workload_name in m.get("workloads", [workload_name])]


def cell(workload_name: str, seed: int, seconds: float, trace: bool, device: torch.device,
         spec: dict = None) -> Cell:
    entry = workload(workload_name, spec)
    return Cell(workload=workload_name, config=program_config(entry["config"]),
                traffic=traffic(entry["traffic"]), limits=limits(workload_name), seed=seed,
                seconds=seconds, trace=trace, device=device)
