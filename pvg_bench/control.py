"""Readings that set a cell's limits: the program's, its control's and a
planted fault's, over many seeds in one process.

    python3 -m pvg_bench.control --workload bair.train --what program --seeds 11,12,13
    python3 -m pvg_bench.control --workload bair.train --what control --seeds 11,12,13

``program``: the cell as the benchmark runs it (a window of ``--seconds``),
its compared numbers per seed.  ``control``: the reference computed in fp8
(the next precision below the configs' bfloat16) put in the program's
place, against the float32 reference.  ``half_batch`` (training cells): the
reference on half of each batch, the mean taken over the rest.  One JSON
line per seed, then the largest and smallest of each number.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from pvg_bench import drive, spec
from pvg_bench.reference import model as ref


def control_numbers(cell: drive.Cell, what: str) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(the compared numbers, the readings) of the fp8 control (``control``)
    or the half-batch fault (``half_batch``), worked out as the program's
    are."""
    config, traffic, seed, device = cell.config, cell.traffic, cell.seed, cell.device
    if traffic["driver"] == "train":
        got = drive.reference_training(config, traffic, seed, device, fp8=what == "control",
                                       half_batch=what == "half_batch")
        want = drive.reference_training(config, traffic, seed, device, fp8=False)
        return drive.compare_training(got, want, config, seed, device)
    if what != "control":
        raise ValueError(f"{what} is a training cell's fault")
    model = drive.loaded_reference(config, seed, device, ref.Precision(fp8=True), vgg=False)[0]
    model.eval()
    with drive.tf32_off():
        served = {i: drive.reference_frames(config, traffic, seed, device, i, model)
                  for i in range(traffic["check_requests"])}
    gaps = drive.play_gaps(config, traffic, seed, device, served, fp8=False)
    return {"frame_gap": gaps.pop("frame_gap")}, gaps


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--what", choices=("program", "control", "half_batch"), required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    collected: Dict[str, list] = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = spec.cell(args.workload, seed, args.seconds, False, device)
        if args.what == "program":
            outcome = drive.run(cell)
            numbers = dict({k: c["value"] for k, c in outcome.checks.items()},
                           **outcome.readings)
        else:
            compared, readings = control_numbers(cell, args.what)
            numbers = dict(compared, **readings)
        for k, v in numbers.items():
            collected.setdefault(k, []).append(v)
        print(json.dumps(dict(workload=args.workload, what=args.what, seed=seed, **numbers)),
              flush=True)
        drive.release(device)
    print(json.dumps(dict(workload=args.workload, what=args.what, seeds=args.seeds,
                          **{f"{k}_max": float(np.max(v)) for k, v in collected.items()},
                          **{f"{k}_min": float(np.min(v)) for k, v in collected.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
