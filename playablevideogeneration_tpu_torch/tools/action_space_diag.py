"""Action-space diagnostic for a convergence-soak run.

Counterpart of ``tools/action_space_diag.py`` of the JAX package.  It reads
the soak's ``run_args.json``, rebuilds the same run and in-memory videos,
loads its ``latest`` checkpoint and prints the confusion matrix between the
model's inferred actions and the square's motion labels (derived from the
videos' metadata), and the Hungarian accuracies against the motion labels
and against the recorded actions.

This separates failure modes the scalar accuracy cannot:
  - an unformed action space (uniform confusion rows);
  - a motion-pure but permuted partition (high Hungarian accuracy);
  - a stratified partition (consistent within a nuisance stratum, such as
    a per-video row, but sign-flipped across strata: rows mix 50/50).

    python -m playablevideogeneration_tpu_torch.tools.action_space_diag --root /tmp/soak

Runs on the GPU by default; ``--device cpu`` on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def motion_labels(movements: np.ndarray, actions_count: int) -> np.ndarray:
    """Motion labels in ``data/synthetic._ACTION_DELTAS`` order: 0 stay,
    1 left, 2 right, 3 up, 4 down (vertical ones only with more than three
    actions)."""
    dx, dy = movements[:, 0], movements[:, 1]
    motion = np.zeros(len(movements), int)
    motion[dx < 0] = 1
    motion[dx > 0] = 2
    if actions_count > 3:
        motion[dy < 0] = 3
        motion[dy > 0] = 4
    return motion


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root", required=True, help="a convergence_soak --root directory")
    parser.add_argument("--max-batches", type=int, default=30)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)

    from playablevideogeneration_tpu_torch.evaluation.hungarian import compute_actions_accuracy
    from playablevideogeneration_tpu_torch.tools import convergence_soak as cs

    with open(os.path.join(args.root, "run_args.json")) as f:
        soak_args = argparse.Namespace(**{**json.load(f), "device": args.device})
    logger = cs.RecordingLogger(os.path.join(args.root, "diag_log.jsonl"))
    try:
        _, datasets, trainer, evaluators = cs.build_soak(soak_args, logger)
        trainer.load_checkpoint()
        print(f"[diag] checkpoint at step {trainer.global_step}")
        actions, movements, recorded = cs.collect_action_movements(
            evaluators["validation"], datasets, max_batches=args.max_batches,
            recorded_actions=True)
    finally:
        logger.close()
    n_actions = soak_args.actions
    n_model = soak_args.model_actions or n_actions
    motion = motion_labels(movements, n_actions)

    conf = np.zeros((n_actions, n_model), int)
    for m, a in zip(motion, actions):
        conf[m, a] += 1
    print("[diag] confusion rows=motion(stay,left,right,up,down) cols=inferred action")
    print(conf)
    for k in range(n_model):
        sel = movements[actions == k]
        mean = sel.mean(0).round(3).tolist() if len(sel) else None
        print(f"[diag] inferred {k}: count={len(sel)} mean_movement={mean}")

    # Square matching over max(model, motion) labels: surplus model
    # clusters map to empty labels and count as errors.
    labels = max(n_actions, n_model)
    acc_motion, mapping = compute_actions_accuracy(actions, motion, labels)
    acc_recorded, recorded_mapping = compute_actions_accuracy(actions, recorded, labels)
    print(f"[diag] hungarian accuracy vs MOTION labels: {acc_motion:.4f} (mapping {mapping})")
    print(f"[diag] hungarian accuracy vs RECORDED actions: {acc_recorded:.4f} "
          f"(mapping {recorded_mapping})")
    print(json.dumps({"accuracy_vs_motion": round(float(acc_motion), 4),
                      "accuracy_vs_recorded_actions": round(float(acc_recorded), 4),
                      "transitions": int(len(actions))}))


if __name__ == "__main__":
    main()
