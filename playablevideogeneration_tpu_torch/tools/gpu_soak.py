"""End-to-end soak of the full offline pipeline on the GPU.

Counterpart of ``tools/tpu_soak.py`` of the JAX package, renamed because it
soaks the card.  It runs the complete reference workflow

    train -> resume -> play -> build_evaluation_dataset -> evaluate_dataset

as separate ``python -m playablevideogeneration_tpu_torch.cli.*``
processes, each reading its config from a YAML file on disk, with every
pretrained backbone (VGG19, LPIPS, the FID Inception and its Inception
Score head, the FVD I3D) active on random weights written in the
converter's ``.npz`` layout and found through ``PVG_PRETRAINED_WEIGHTS``.
This is the check that calling the CLIs' functions inside one process
cannot stand in for: ``main()``, argparse, the ``--device`` default, the
weight resolution from the environment, and a fresh process loading the
built kernels.

Mirrors the reference flow train.py -> build_evaluation_dataset.py:21-68
-> evaluate_dataset.py:22-58.

    python -m playablevideogeneration_tpu_torch.tools.gpu_soak [--root DIR]

Runs on the GPU by default; ``--device cpu`` passes ``--device cpu`` to
every stage.  Exit code 0 means every stage ran and ``data.yml`` carries
finite values for every required metric family and no ``*_unavailable``
marker; it exits 1 otherwise.  The density plots are written only where
matplotlib is installed; the summary lists the plots.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PACKAGE = "playablevideogeneration_tpu_torch"
STAGES = ("train", "resume", "play", "build", "evaluate")
# The metric families that must be real numbers when every backbone is on.
REQUIRED = ["fid", "fvd", "lpips/avg", "inception_score", "mse/avg", "psnr/avg", "ssim/avg",
            "vgg_sim/avg", "detection/add/avg", "action_classification/linear/accuracy",
            "action_variance/avg_variance/mean"]
LPIPS_CHANNELS = (64, 128, 256, 512, 512)


def build_fixture(root: str, size: int = 32, length: int = 12, actions: int = 3) -> str:
    """Writes the synthetic splits under ``root/data`` and a tiny run config
    (hidden 8, batch 2, 4 frames, 1 pretraining and 2 full-phase steps) as
    ``root/config.yaml``; returns the config's path."""
    import yaml

    from playablevideogeneration_tpu_torch.data.synthetic import (
        build_synthetic_dataset,
        make_synthetic_config,
    )

    shutil.rmtree(root, ignore_errors=True)
    build_synthetic_dataset(root + "/data", videos_per_split=2, length=length, height=size,
                            width=size, actions_count=actions)
    cfg = make_synthetic_config(
        data_root=root + "/data", output_root=root + "/out", height=size, width=size,
        actions_count=actions, batch_size=2, observations_count=4, observation_stacking=1,
        hidden_state_size=8, state_features=8, pretraining_steps=1, max_steps=3)
    cfg["training"]["batching"]["observations_count_start"] = 4
    cfg["evaluation"]["batching"]["observations_count"] = 4
    # The builder reconstructs the test set at eval length with 2 GT frames.
    cfg["evaluation_dataset"]["ground_truth_observations_init"] = 2
    path = root + "/config.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def write_vgg_weights(path: str, seed: int) -> None:
    """A random VGG19 seeded with ``seed`` as ``tools/convert_weights.py``
    writes ``vgg19.npz`` (flax names and HWIO kernels)."""
    import torch

    from playablevideogeneration_tpu_torch.models.vgg import make_vgg
    from playablevideogeneration_tpu_torch.utils.pretrained import save_variables_npz

    vgg = make_vgg("cpu", torch.float32, seed)
    params = {}
    for name, conv in vgg.named_children():
        params[name] = {"kernel": conv.weight.detach().permute(2, 3, 1, 0).numpy(),
                        "bias": conv.bias.detach().numpy()}
    save_variables_npz({"params": params}, path)


def write_lpips_weights(path: str, seed: int) -> None:
    """Random LPIPS heads as the converter writes ``lpips_lin.npz``: one
    (C,) vector per VGG level, uniform in [0, 1)."""
    rng = np.random.default_rng(seed)
    np.savez(path, **{f"lin{i}": rng.uniform(0.0, 1.0, size=(c,)).astype(np.float32)
                      for i, c in enumerate(LPIPS_CHANNELS)})


def build_random_backbone_weights(weights_dir: str) -> None:
    """Random variables for every backbone, saved in the converters' npz
    layout, so that every backbone's path (resolution, loading, device
    execution) runs without true pretrained weights.  CPU work: the stages
    need the card, this process does not."""
    from playablevideogeneration_tpu_torch.evaluation.metrics import i3d, inception
    from playablevideogeneration_tpu_torch.utils import pretrained

    os.makedirs(weights_dir, exist_ok=True)

    def path(name):
        return os.path.join(weights_dir, pretrained.WEIGHT_FILES[name])

    write_vgg_weights(path("vgg19"), 0)
    # With the 1008-way 'fc' head the converter keeps, so that the
    # Inception Score runs too.
    pretrained.save_variables_npz(inception.random_inception_variables(0, with_fc=True),
                                  path("fid_inception"))
    pretrained.save_variables_npz(i3d.random_i3d_variables(0), path("i3d"))
    write_lpips_weights(path("lpips_lin"), 0)


def build_eval_config(root: str, size: int = 32, length: int = 12, actions: int = 3) -> str:
    """Writes the offline evaluation's config (the builder's videos against
    the test split, the blob detector, the Inception Score on) as
    ``root/eval_config.yaml``; returns its path."""
    import yaml

    cfg = {
        "logging": {"run_name": "synthetic",
                    "output_root": root + "/out/evaluation_results"},
        "data": {"target_input_size": [size, size], "actions_count": actions,
                 "ground_truth_available": True},
        "reference_data": {"data_root": root + "/data/test", "crop": None},
        "generated_data": {
            "data_root": root + "/out/results/synthetic/evaluation_dataset",
            "crop": None},
        "evaluation": {
            "evaluator": "evaluation.dataset_evaluator",
            "detector": "blob",
            "compute_inception_score": True,
            "batching": {"batch_size": 1, "observations_count": 4,
                         "skip_frames": 0, "observation_stacking": 1,
                         "num_workers": 1},
        },
    }
    path = root + "/eval_config.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def stage_argvs(config: str, eval_config: str, device: str) -> Dict[str, List[str]]:
    """Each stage's command line: the JAX tool's, on the port's CLIs, with
    ``--device``."""
    cli = f"{PACKAGE}.cli"

    def command(module, *args):
        return [sys.executable, "-u", "-m", f"{cli}.{module}", *args, "--device", device]

    return {
        "train": command("train", "--config", config),
        "resume": command("train", "--config", config),
        "play": command("play", "--config", config, "--frames", "8"),
        "build": command("build_evaluation_dataset", "--config", config),
        "evaluate": command("evaluate_dataset", "--config", eval_config),
    }


# The log file of each stage, as the JAX tool names them.
LOG_NAMES = {"build": "build_evaluation_dataset", "evaluate": "evaluate_dataset"}


def run_stage(name: str, argv: list, env: dict, log_dir: str, timeout: int = 1800) -> float:
    """Runs one stage with its output in ``log_dir/<name>.log``; returns its
    seconds, or exits 1 with the log's last lines when it fails."""
    log_path = os.path.join(log_dir, f"{name}.log")
    start = time.time()
    with open(log_path, "w") as log:
        proc = subprocess.run(argv, env=env, stdout=log, stderr=subprocess.STDOUT,
                              timeout=timeout, cwd=REPO)
    elapsed = time.time() - start
    if proc.returncode != 0:
        sys.stderr.write(f"[gpu_soak] stage '{name}' FAILED (rc={proc.returncode}); "
                         "last lines:\n")
        with open(log_path) as log:
            sys.stderr.write("".join(log.readlines()[-40:]))
        raise SystemExit(1)
    print(f"[gpu_soak] {name}: OK in {elapsed:.1f}s ({log_path})", flush=True)
    return elapsed


def validate(metrics: dict) -> dict:
    """The required families that are missing, the ``*_unavailable``
    markers and the non-finite values of ``data.yml``'s metrics: every
    backbone ran on random weights, so each family must be a real number."""
    return {
        "missing_families": [k for k in REQUIRED if k not in metrics],
        "unavailable_markers": [k for k in metrics if k.endswith("_unavailable")],
        "nonfinite": [k for k, v in metrics.items()
                      if isinstance(v, float) and not math.isfinite(v)],
    }


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "gpu_soak"))
    parser.add_argument("--device", default="cuda",
                        help="torch device every stage runs on (default: cuda)")
    parser.add_argument("--stages", default=",".join(STAGES),
                        help="comma-separated subset to run (fixture and weights are "
                             "rebuilt unless --keep-fixture)")
    parser.add_argument("--keep-fixture", action="store_true",
                        help="reuse an existing --root fixture")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the soak; returns its summary (exits 1 when a stage fails or
    the metrics do not validate)."""
    args = parse_args(argv)
    stages_wanted = {s.strip() for s in args.stages.split(",") if s.strip()}
    unknown = stages_wanted - set(STAGES)
    if unknown or not stages_wanted:
        raise SystemExit(f"--stages got {sorted(unknown) or 'nothing'}; "
                         f"known stages: {sorted(STAGES)}")

    config = args.root + "/config.yaml" if args.keep_fixture else build_fixture(args.root)
    build_random_backbone_weights(args.root + "/weights")
    eval_config = build_eval_config(args.root)
    env = dict(os.environ, PVG_PRETRAINED_WEIGHTS=args.root + "/weights")
    log_dir = args.root + "/logs"
    os.makedirs(log_dir, exist_ok=True)

    times = {}
    for name, argv_ in stage_argvs(config, eval_config, args.device).items():
        if name in stages_wanted:
            times[name] = run_stage(LOG_NAMES.get(name, name), argv_, env, log_dir)
    summary = {"device": args.device, "stage_seconds": times}

    if "evaluate" not in stages_wanted:
        # No data.yml was (re)produced this run: validating one would crash
        # on a missing file or pass a stale one from an earlier run.
        print("[gpu_soak] " + json.dumps(summary))
        print(f"[gpu_soak] PASS (partial): stages {sorted(stages_wanted)} executed; metric "
              "validation requires the 'evaluate' stage")
        return summary

    import yaml

    results_dir = args.root + "/out/evaluation_results/synthetic"
    with open(results_dir + "/data.yml") as f:
        metrics = yaml.safe_load(f)
    failures = validate(metrics)
    summary.update(
        metrics_count=len(metrics), **failures,
        plots_written=sorted(f for f in os.listdir(results_dir) if f.endswith(".pdf")),
        fid=metrics.get("fid"), fvd=metrics.get("fvd"), lpips=metrics.get("lpips/avg"),
        inception_score=metrics.get("inception_score"))
    print("[gpu_soak] " + json.dumps(summary))
    if any(failures.values()):
        raise SystemExit(1)
    print(f"[gpu_soak] PASS: full pipeline executed on {args.device} with all backbones "
          "active")
    return summary


if __name__ == "__main__":
    main()
