"""Convergence soak: evidence that the port learns an action space.

Counterpart of ``tools/convergence_soak.py`` of the JAX package.  It runs
a multi-phase training (pretraining, then the full model) on the
action-conditioned moving-square videos of ``data/synthetic.py`` long
enough for the action space to form, and records:

  - ``train_log.jsonl``   every trainer and evaluator metric logged, by step
  - ``eval_curve.jsonl``  per evaluation the reconstruction losses and the
                          Hungarian ``actions_accuracy`` of the Gumbel and
                          the one-hot pass (chance = 1/actions_count)
  - ``summary.json``      the loss trend (first against last evaluation),
                          the best accuracies, the target check and the
                          per-action mean movements
  - ``plots/``            the density plots of (inferred action, square
                          movement) pairs, when matplotlib is installed

The videos are made in memory with the arguments that
``build_synthetic_dataset`` would pass (no Pillow needed).  A rerun with
the same ``--root`` resumes from the ``latest`` checkpoint, which is saved
before every evaluation; ``best_accuracy`` keeps the checkpoint of the
best Gumbel-pass accuracy.  The exit code is 1 when the target accuracy
was not reached.

    python -m playablevideogeneration_tpu_torch.tools.convergence_soak \\
        --root /tmp/soak --actions 3 --action-space-dimension 1 --fixed-y \\
        --steps 12000 --pretraining-steps 300 --eval-every 500

Runs on the GPU by default; ``--device cpu`` on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

CHANCE_NOTE = "chance accuracy = 1/actions_count"
# The split directories build_synthetic_dataset writes, in the order it
# seeds their videos, and the datasets they become.
SPLITS = (("train", "train"), ("val", "validation"), ("test", "test"))


def build_config(args) -> dict:
    """A scaled breakout-class config (reference configs/02_breakout.yaml:
    smooth-MI trainer, MI lambda 0.15, Gumbel temperature 1.0 -> 0.4, a
    constant teacher-forcing budget) sized for an ``args.steps`` run; the
    JAX tool's for the same arguments."""
    from playablevideogeneration_tpu_torch.data.synthetic import make_synthetic_config

    size, t = args.size, args.observations
    model_actions = getattr(args, "model_actions", None) or args.actions
    cfg = make_synthetic_config(
        data_root=os.path.join(args.root, "data"),
        output_root=os.path.join(args.root, "out"),
        height=size, width=size, actions_count=model_actions,
        batch_size=args.batch_size, observations_count=t, observation_stacking=1,
        hidden_state_size=args.hidden_state_size, state_features=args.state_features,
        pretraining_steps=args.pretraining_steps, max_steps=args.steps,
        action_space_dimension=args.action_space_dimension)
    tr = cfg["training"]
    tr["batching"]["observations_count_start"] = t
    tr["batching"]["observations_count_steps"] = 1
    # Breakout keeps 6 of 9 frames teacher-forced throughout
    # (02_breakout.yaml:86-90); the same ratio here.
    tr["ground_truth_observations_start"] = args.gt_observations
    tr["ground_truth_observations_end"] = args.gt_observations
    tr["ground_truth_observations_steps"] = max(args.steps, 1)
    tr["gumbel_temperature_start"] = 1.0
    tr["gumbel_temperature_end"] = 0.4
    tr["gumbel_temperature_steps"] = max(args.steps * 2 // 3, 1)
    tr["save_freq"] = 10 * args.eval_every
    if args.no_variations:
        # With the continuous variation channel off, all motion must flow
        # through the discrete action and its centroid direction.
        cfg["model"]["action_network"]["use_variations"] = False
    cfg["evaluation"]["max_evaluation_batches"] = args.eval_batches
    cfg["evaluation"]["batching"]["batch_size"] = 8
    cfg["evaluation"]["batching"]["observations_count"] = t
    cfg["tpu"] = {"compute_dtype": args.compute_dtype, "remat": bool(args.remat)}
    return cfg


def make_split_videos(args, seed: int = 0) -> Dict[str, list]:
    """{"train" | "validation" | "test": videos}: the moving-square videos
    that ``build_synthetic_dataset`` writes for the soak, made in memory;
    the i-th video overall is seeded ``seed + i``."""
    from playablevideogeneration_tpu_torch.data.synthetic import make_moving_square_video

    fixed_y = (args.size - 10) // 2 if args.fixed_y else None
    videos, index = {}, seed
    for _, name in SPLITS:
        videos[name] = [make_moving_square_video(
            length=args.video_length, height=args.size, width=args.size,
            actions_count=args.actions, seed=index + i, square=10, step_pixels=4,
            fixed_y=fixed_y) for i in range(args.videos_per_split)]
        index += args.videos_per_split
    return videos


def make_datasets(config: dict, videos: Mapping[str, list]) -> dict:
    """The run's datasets over the in-memory videos, with the config's
    batching and transforms per split."""
    from playablevideogeneration_tpu_torch.data.transforms import get_final_transforms
    from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset

    transforms = get_final_transforms(config)
    batching = {"train": config["training"]["batching"],
                "validation": config["evaluation"]["batching"],
                "test": config["evaluation"]["batching"]}
    return {name: VideoDataset.from_videos(videos[name], batching[name], transforms[name])
            for name in videos}


class RecordingLogger:
    """Logger that tees every metric dict into a JSONL file."""

    def __init__(self, path: str):
        from playablevideogeneration_tpu_torch.utils.logging import Logger

        self._inner = Logger(use_wandb=False)
        self._f = open(path, "a")

    def print(self, *a, **kw):
        self._inner.print(*a, **kw)

    def histogram(self, np_histogram):
        return None

    def log(self, values, step=None):
        record = {"step": step, "t": round(time.time(), 1)}
        for key, value in values.items():
            if isinstance(value, (int, float)):
                record[key] = round(float(value), 6)
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def collect_action_movements(evaluator, datasets, max_batches: int = 12,
                             recorded_actions: bool = False) -> Tuple[np.ndarray, ...]:
    """(inferred action, ground-truth square movement) pairs over the test
    split.

    The inferred actions are the model's on real sequences
    (``selected_actions`` of the evaluator's forward, Gumbel sampler, noise
    from a generator seeded 7); the movements are the square's position
    deltas in the videos' metadata (``state``, data/synthetic.py).  With
    ``recorded_actions``, a third array holds the videos' recorded action
    of each transition."""
    from playablevideogeneration_tpu_torch.data.loader import DataLoader
    from playablevideogeneration_tpu_torch.evaluation.evaluator import eval_mode
    from playablevideogeneration_tpu_torch.utils.tensor_ops import sequence_to_nchw

    loader = DataLoader(datasets["test"], batch_size=8, shuffle=False, drop_last=True,
                        num_workers=1)
    evaluator.set_action_sampler(None)
    generator = torch.Generator(device=evaluator.device).manual_seed(7)
    all_actions, all_movements, all_recorded = [], [], []
    with eval_mode(evaluator.model):
        for i, batch in enumerate(loader):
            if i >= max_batches:
                break
            observations = sequence_to_nchw(batch.observations, evaluator.device)
            actions = torch.as_tensor(batch.actions, device=evaluator.device)
            out = evaluator._forward(observations, actions, generator)
            selected = out.selected_actions.cpu().numpy()  # (B, T-1)
            for b in range(selected.shape[0]):
                video, start = batch.videos[b], batch.initial_frames[b]
                states = np.asarray([video.metadata[start + t]["state"]
                                     for t in range(batch.observations.shape[1])])
                all_actions.append(selected[b])
                all_movements.append(states[1:] - states[:-1])  # (T-1, 2)
                all_recorded.append(batch.actions[b, :-1])
    pairs = (np.concatenate(all_actions), np.concatenate(all_movements))
    return pairs + (np.concatenate(all_recorded),) if recorded_actions else pairs


def run_eval(evaluators, trainer, eval_f, save_images: bool = True) -> dict:
    """One evaluation round, as cli/train.py runs it: the Gumbel pass for
    the losses (and, with ``save_images``, the example images), then the
    one-hot pass for the Hungarian accuracy; appends its record to
    ``eval_f``."""
    from playablevideogeneration_tpu_torch.evaluation.action_sampler import (
        one_hot_action_sampler,
    )

    ev = evaluators["validation"]
    with trainer.full_model_in(ev):
        ev.set_action_sampler(None)
        metrics = ev.evaluate(trainer.global_step, save_images=save_images)
        ev.set_action_sampler(one_hot_action_sampler, label="one_hot")
        onehot = ev.evaluate(trainer.global_step, save_images=False)
    record = {
        "step": trainer.global_step,
        "observations_loss": metrics.get("validation/observations_loss/avg"),
        "perceptual_loss": metrics.get("validation/perceptual_loss/avg"),
        "states_loss": metrics.get("validation/states_loss/avg"),
        "actions_accuracy": metrics.get("validation/actions_accuracy"),
        "one_hot_actions_accuracy": onehot.get("validation/one_hot/actions_accuracy"),
        "samples_entropy": metrics.get("validation/samples_entropy"),
        "t": round(time.time(), 1),
    }
    eval_f.write(json.dumps(record) + "\n")
    eval_f.flush()
    return record


def read_eval_curve(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def build_soak(args, logger):
    """(config, datasets, trainer, evaluators) of the soak described by
    ``args`` (the CLI's arguments or ``run_args.json``), its state
    initialised, on ``args.device``."""
    from playablevideogeneration_tpu_torch.cli.train import build_run
    from playablevideogeneration_tpu_torch.config.configuration import Configuration

    configuration = Configuration(config=build_config(args))
    configuration.check_config(check_data_root=False)
    configuration.create_directory_structure()
    config = configuration.get_config()
    datasets = make_datasets(config, make_split_videos(args))
    _, datasets, trainer, evaluators, _ = build_run(
        config, logger=logger, device=args.device, datasets=datasets)
    trainer.init_state()
    return config, datasets, trainer, evaluators


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root", default="/tmp/convergence_soak")
    parser.add_argument("--artifact-dir", default=None,
                        help="where to copy the final evidence (default: <root>/artifacts)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda)")
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--pretraining-steps", type=int, default=300)
    parser.add_argument("--eval-every", type=int, default=250)
    parser.add_argument("--eval-batches", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--size", type=int, default=48)
    parser.add_argument("--observations", type=int, default=6)
    parser.add_argument("--gt-observations", type=int, default=4)
    parser.add_argument("--actions", type=int, default=3)
    parser.add_argument("--model-actions", type=int, default=None,
                        help="model discrete-action count when it should exceed the "
                             "dataset's motion count (03_tennis.yaml uses 7 for about 5 "
                             "motions); the Hungarian accuracy still scores against the "
                             "true labels, surplus clusters counting as errors")
    parser.add_argument("--hidden-state-size", type=int, default=32)
    parser.add_argument("--state-features", type=int, default=32)
    parser.add_argument("--compute-dtype", default="bfloat16")
    parser.add_argument("--remat", type=int, default=0)
    parser.add_argument("--videos-per-split", type=int, default=24)
    parser.add_argument("--video-length", type=int, default=64)
    parser.add_argument("--target-accuracy", type=float, default=0.9)
    parser.add_argument("--action-space-dimension", type=int, default=1,
                        help="direction-latent dimensions; the reference uses 1 for 1-D "
                             "motion like this dataset's (02_breakout.yaml:56)")
    parser.add_argument("--fixed-y", action="store_true",
                        help="pin the square's row (a breakout-style 1-D world)")
    parser.add_argument("--no-variations", action="store_true",
                        help="disable the continuous variation channel so that motion "
                             "must flow through the discrete actions")
    parser.add_argument("--no-example-images", action="store_true",
                        help="skip the evaluator's example images, which need Pillow")
    parser.add_argument("--stop-at", type=int, default=None,
                        help="end this invocation at this step, a multiple of --eval-every, "
                             "without the evidence; a rerun with the same --root and "
                             "arguments continues the run")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from playablevideogeneration_tpu_torch.evaluation.plotting import density_plots
    from playablevideogeneration_tpu_torch.utils import checkpoint as ckpt_lib

    os.makedirs(args.root, exist_ok=True)
    # The run's arguments, from which the diagnostic rebuilds the same run.
    with open(os.path.join(args.root, "run_args.json"), "w") as f:
        json.dump(vars(args), f, indent=2)
    logger = RecordingLogger(os.path.join(args.root, "train_log.jsonl"))
    config, datasets, trainer, evaluators = build_soak(args, logger)
    latest = os.path.join(config["logging"]["save_root_directory"], "latest")
    if ckpt_lib.checkpoint_exists(latest):
        trainer.load_checkpoint()
        print(f"[soak] resumed at step {trainer.global_step}")

    eval_path = os.path.join(args.root, "eval_curve.jsonl")
    best_seen = max((r["actions_accuracy"] for r in read_eval_curve(eval_path)), default=0.0)
    start = time.time()
    stop = args.steps if args.stop_at is None else min(args.stop_at, args.steps)
    try:
        with open(eval_path, "a") as eval_f:
            while trainer.global_step < stop:
                boundary = min(stop,
                               (trainer.global_step // args.eval_every + 1) * args.eval_every)
                while trainer.global_step < boundary:
                    before = trainer.global_step
                    trainer.train_epoch(max_steps=boundary)
                    if trainer.global_step == before:
                        raise RuntimeError("no training steps performed this epoch")
                # A step an epoch ends on for a length change counts, untaken.
                trainer.state.step = trainer.global_step
                trainer.save_checkpoint()
                record = run_eval(evaluators, trainer, eval_f,
                                  save_images=not args.no_example_images)
                if record["actions_accuracy"] > best_seen:
                    # At toy scale the discrete space can churn after it peaks.
                    best_seen = record["actions_accuracy"]
                    trainer.save_checkpoint("best_accuracy")
                print(f"[soak] step {record['step']}: rec={record['observations_loss']:.4f} "
                      f"acc={record['actions_accuracy']:.3f} "
                      f"({time.time() - start:.0f}s elapsed)", flush=True)
    finally:
        logger.close()
    if trainer.global_step < args.steps:
        print(f"[soak] stopped at step {trainer.global_step} of {args.steps} "
              f"({time.time() - start:.0f}s); rerun to continue", flush=True)
        return

    # Evidence.
    with trainer.full_model_in(evaluators["validation"]):
        actions, movements = collect_action_movements(evaluators["validation"], datasets)
    artifact_dir = args.artifact_dir or os.path.join(args.root, "artifacts")
    plots_dir = os.path.join(artifact_dir, "plots")
    os.makedirs(plots_dir, exist_ok=True)
    model_actions = args.model_actions or args.actions
    density_plots.plot_all(actions, movements, model_actions, plots_dir, prefix="soak_")

    per_action = {}
    for a in range(model_actions):
        sel = movements[actions == a]
        per_action[str(a)] = {
            "count": int(sel.shape[0]),
            "mean_movement": [round(float(v), 3) for v in sel.mean(0)] if len(sel) else None,
        }

    # The loss trend over the whole history (the curve is appended across
    # resumed runs).
    eval_records = read_eval_curve(eval_path)
    first, last = eval_records[0], eval_records[-1]
    best_acc = max(r["actions_accuracy"] for r in eval_records)
    # The one-hot pass selects actions by argmax, as the reference's
    # evaluation-dataset protocol does; the sampled accuracy also pays the
    # Gumbel temperature's entropy.
    best_onehot = max((r.get("one_hot_actions_accuracy") or 0.0) for r in eval_records)
    device = torch.device(args.device)
    summary = {
        "steps": trainer.global_step,
        "pretraining_steps": args.pretraining_steps,
        "actions_count": args.actions,
        "model_actions_count": model_actions,
        "chance_accuracy": round(1.0 / args.actions, 4),
        "first_eval": first,
        "last_eval": last,
        "best_actions_accuracy": best_acc,
        "best_one_hot_actions_accuracy": best_onehot,
        "loss_decreased": last["observations_loss"] < first["observations_loss"],
        "target_accuracy": args.target_accuracy,
        "target_met": max(best_acc, best_onehot) >= args.target_accuracy,
        "per_action_movements": per_action,
        "wall_seconds": round(time.time() - start, 1),
        "device": args.device,
        "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
        "compute_dtype": args.compute_dtype,
        "use_variations": not args.no_variations,
        "action_space_dimension": args.action_space_dimension,
        "note": CHANCE_NOTE,
    }
    with open(os.path.join(artifact_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    if os.path.abspath(artifact_dir) != os.path.abspath(args.root):
        import shutil

        for name in ("train_log.jsonl", "eval_curve.jsonl"):
            shutil.copyfile(os.path.join(args.root, name), os.path.join(artifact_dir, name))
    print("[soak] " + json.dumps({k: summary[k] for k in (
        "steps", "best_actions_accuracy", "best_one_hot_actions_accuracy",
        "chance_accuracy", "loss_decreased", "target_met")}), flush=True)
    if not summary["target_met"]:
        print("[soak] FAIL: action space did not reach target accuracy", flush=True)
        raise SystemExit(1)
    print(f"[soak] PASS: evidence written to {artifact_dir}", flush=True)


if __name__ == "__main__":
    main()
