"""Times the bf16 train step of BAIR's training loop (batch 8, 7 frames, no
per-step checkpointing, smooth MI, seeded weights and batch on the card)
in one or more source trees, in turns, on one NVIDIA GPU.

    python3 chip_train_step_ab.py [--pairs N] TREE [TREE ...]

Each TREE is a directory holding ``playablevideogeneration_tpu_torch`` (a
checkout, or a commit unpacked with ``git archive``).  The trees run in
turns, in the order given and then reversed (A B B A ... for two), ``N``
times each, each run in a process of its own that builds its kernels,
warms up and times ``Trainer.train_step`` on the host's clock (it ends in
one device-to-host copy of its metrics).  Prints one JSON line per run,
the card's name and power limit, and a summary line of medians.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

WARMUP_STEPS, TIMED_STEPS = 3, 20

RUN = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from playablevideogeneration_tpu_torch.ops.cuda import build
from playablevideogeneration_tpu_torch.training.bench_harness import (
    build_synthetic_trainer, make_synthetic_batch)
build.build()
trainer = build_synthetic_trainer(height=256, width=256, batch_size=8, observations_count=7,
                                  compute_dtype="bfloat16", remat=False, smooth_mi=True,
                                  pretraining_steps=0, device="cuda", seed=0)
batch = make_synthetic_batch(batch_size=8, observations_count=7, height=256, width=256, seed=0)
batch = type(batch)(*(torch.as_tensor(x, device="cuda") for x in batch))
times = []
for i in range(%d + %d):
    torch.cuda.synchronize()
    start = time.perf_counter()
    trainer.train_step(batch)
    if i >= %d:
        times.append((time.perf_counter() - start) * 1e3)
print(json.dumps({"tree": sys.argv[1], "ms": times, "median_ms": statistics.median(times)}))
""" % (WARMUP_STEPS, TIMED_STEPS, WARMUP_STEPS)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--pairs", type=int, default=1)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_train_step_ab.py: torch.cuda.is_available() is False; it needs an "
                 "NVIDIA GPU")
    trees = [os.path.abspath(t) for t in args.trees]
    medians = {}
    for tree in (trees + trees[::-1]) * args.pairs:
        out = subprocess.run([sys.executable, "-c", RUN, tree], capture_output=True, text=True,
                             timeout=600)
        if out.returncode:
            sys.exit(f"run {tree} failed:\n{out.stderr[-3000:]}")
        record = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(record), flush=True)
        medians.setdefault(tree, []).append(record["median_ms"])
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    print(json.dumps({"median_ms_by_run": medians, "nvidia_smi": card}))


if __name__ == "__main__":
    main()
