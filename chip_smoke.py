"""Drives the PyTorch/CUDA port's play and training routes, its training
loop and the entry points after training, on one NVIDIA Hopper GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on a failed check:

1. device: a CUDA device must be visible; prints nvidia-smi's name and
   power limit;
2. build: compiles every kernel under
   ``playablevideogeneration_tpu_torch/ops/cuda/csrc`` with nvcc for sm_90a;
   Reports each kernel's registers and spills (``-Xptxas=-v``) and, where
   the toolkit has ``cuobjdump``, its static SASS instruction count;
3. kernels: holds each kernel against its plain PyTorch version on the card
   at every shape the flagship's play and training steps give it (batch 1
   and 16), the training loop's gate shapes at batch 8, every shape an
   evaluation or builder batch gives K3 (8 x 30 frames: ``EVAL_NORM_SHAPES``)
   and phase 11's f32 builder batch of 2 x 8 frames gives K1 and K3, plus a
   ragged case (3x65x25x40), a C*H*W that is no multiple of a vector
   (3x5x7x9) and inputs whose storage starts one element into its buffer,
   in f32 and bf16: each must equal its plain version bit for bit, and each
   case must take the path it should (packs of 4 elements for K1 and of 16
   bytes for K3, or one element per thread where the sizes or the
   alignment forbid them); and the gate
   update's autograd function (K1 forward, K2 backward) against autograd
   through the plain gate math (1e-5);
4. play route: the bf16 flagship (configs/01_bair.yaml, seeded random
   weights and BatchNorm statistics) through ``PlaySession``: start, three
   ``generate_next``, ``generate_next_u8``, ``generate_next_interpolation``
   and a 64-action ``rollout``; every step must launch the gate kernel 3
   times and the norm kernel 15 times, frames must be finite and in
   [-1, 1], and the rollout must synchronise with the host once; one of
   the model's frozen BatchNorm + LeakyReLU calls, profiled, must run
   exactly one kernel, K3 (the BatchNorm's fold runs inside it);
5. parity: the same weights in f32 with TF32 off through the kernels on the
   card, and through the plain versions on the CPU; three steps must agree
   to 1e-3;
6. timings: each kernel's device time per launch at its flagship shapes,
   warm (the same inputs back to back, in L2) and cold (rotating over
   more than 100 MB of distinct inputs), beside its memory bound and its
   plain version's time, and likewise K1 and K2 at the loop's batch of 8
   and K3 at the three largest shapes of an evaluation batch; the play
   step's latency, the rollout's frame rate, and the step's kernel count
   and device-time breakdown;
7. train route: the bf16 flagship trainer (batch 16, 12 frames, smooth MI,
   per-step activation checkpointing, seeded weights and batch) takes one
   pretraining and three full-phase steps; each must give a finite loss and
   finite gradient norms and launch K1 66 times (33 forward, 33 in the
   checkpoint recompute), K2 33 times and K3 never; the parameters must
   change;
8. train parity: one full-phase step in f32 with TF32 off, at full width on
   a short batch (2 x 4 frames, 2 ground-truth frames), through the kernels
   on the card and the plain versions on the CPU, with the same weights and
   the same noise (drawn from one CPU generator): the loss and every term
   within rtol 1e-3, the per-subnetwork gradient norms within rtol 1e-2;
9. train timings: K1's and K2's device time per launch at the training
   shapes, warm and cold, beside their bounds and plain versions' times,
   the median bf16 train step, ``train_frames_per_sec`` (B*T per step),
   peak device memory, and the device's busy and idle share and
   kernel-time breakdown over two profiled steps (the port's kernels listed
   one by one);
10. train loop: BAIR's config (``BAIR_CONFIG``, pinned to
   configs/01_bair.yaml by a CPU test, with ``LOOP_OVERRIDES``) through
   ``cli.train.train`` on in-memory synthetic videos at 256x256 (the card's
   machine has neither Pillow nor PyYAML): batch 8 at 7 frames, 2
   pretraining and 4 full-phase steps, ``latest`` and ``checkpoint_6``, and
   the evaluation's three passes (Gumbel, one-hot, ground truth through the
   Hungarian mapping) at 8 x 30 frames.  Every train step must give finite
   values, the schedules' values at its step, and launch K1 and K2 3(T-1)
   times each and K3 never (steps after an evaluation included); every
   evaluation batch K1 87 and K3 446 times and K2 never; one-hot samples
   no entropy and the ground-truth pass accuracy 1; a fresh run's
   ``load_checkpoint`` must restore every tensor and step exactly, and a
   second ``train`` must resume and take 2 steps.  Prints the loop's step
   period beside bare ``train_step``s (batch on the card, batch on the
   host), evaluation seconds, checkpoint size and save/load seconds, peak
   memory, and the device's idle share over two profiled loop steps.
11. after training, on phase 10's run and its ``latest`` checkpoint, at
   BAIR's full width in bf16: the play CLI (``cli.play.load_play_session``
   and its scripted 64-frame rollout: 3 K1 + 15 K3 launches per frame, no
   K2, one synchronisation, uint8 frames; frames/s), ``cli.interpolate``
   (11 factors x 4 frames, in memory), a reference ``.pth.tar`` written
   from the played weights and imported by ``Trainer.load_reference_weights``
   into a model seeded otherwise (every tensor bit for bit, then a play
   step), the evaluation-dataset builder over 2 batches of 8 x 30 test
   sequences on a model in training mode (87 K1 + 446 K3 per batch, no K2;
   uint8 frames and the metadata; the mode restored, and a train step
   right after runs no K3), the offline evaluation (``cli.evaluate_dataset``
   with configs/evaluation/01_bair.yaml's settings, ``BAIR_EVALUATION_CONFIG``,
   on the builder's videos in memory, with random VGG19 and LPIPS weights
   written in the converter's layout: every metric key, the markers of the
   absent backbones, finite values; seconds per batch split into frame
   metrics with VGG19, LPIPS and the host's share; peak memory), and last
   f32 with TF32 off against the CPU's plain path: one builder batch of 2 x
   8 frames within 1e-3 (the CPU following the card's inferred actions,
   which must match its own but for ties within 1e-4 of log-probability),
   the frame metrics of one evaluation batch within rtol 1e-4.

It prints JSON lines as it goes, then the kernels' summary line (``ms``,
``cold_ms``, ``plain_ms`` and ``bound_ms`` there are per step of the
kernel's route: the sum over a bf16 play step's launches for K1 and K3,
over a bf16 training step's 33 K2 launches for K2; ``launches`` counts
phase 4's, 7's, 10's and 11's runs, without the f32 parity checks), the
card's nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import importlib.util
import io
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from playablevideogeneration_tpu_torch.cli.build_evaluation_dataset import (
    make_evaluation_dataset_builder,
)
from playablevideogeneration_tpu_torch.cli.evaluate_dataset import evaluate_dataset
from playablevideogeneration_tpu_torch.cli.interpolate import interpolate
from playablevideogeneration_tpu_torch.cli.play import load_play_session, scripted_rollout
from playablevideogeneration_tpu_torch.cli.train import build_run, train
from playablevideogeneration_tpu_torch.config.configuration import (
    Configuration,
    EvaluationConfiguration,
)
from playablevideogeneration_tpu_torch.data.synthetic import make_moving_square_video
from playablevideogeneration_tpu_torch.data.transforms import (
    get_evaluation_transforms,
    get_final_transforms,
)
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset, collate
from playablevideogeneration_tpu_torch.evaluation.builder import EvaluationDatasetBuilder
from playablevideogeneration_tpu_torch.evaluation.dataset_evaluator import (
    DatasetEvaluator,
    DatasetEvaluatorBair,
)
from playablevideogeneration_tpu_torch.evaluation.action_sampler import (
    zero_action_variation_sampler,
)
from playablevideogeneration_tpu_torch.evaluation.evaluator import Evaluator, evaluation_forward
from playablevideogeneration_tpu_torch.evaluation.metrics.lpips import (
    load_lpips_linear_weights,
    make_lpips_fn,
)
from playablevideogeneration_tpu_torch.inference.play_session import PlaySession
from playablevideogeneration_tpu_torch.models.caddy import flagship_model, make_model
from playablevideogeneration_tpu_torch.models.layers import BatchNorm
from playablevideogeneration_tpu_torch.ops.cuda import build
from playablevideogeneration_tpu_torch.ops.cuda.convlstm_gates import (
    _PACK as GATE_PACK,
    _gate_math,
    _gate_math_bwd,
    fused_lstm_gates,
    fused_lstm_gates_bwd,
)
from playablevideogeneration_tpu_torch.training.bench_harness import (
    build_synthetic_trainer,
    make_synthetic_batch,
    make_synthetic_config,
)
from playablevideogeneration_tpu_torch.ops.cuda.fused_norm_act import (
    _batch_norm_leaky_relu,
    fused_batch_norm_leaky_relu,
)
from playablevideogeneration_tpu_torch.training.trainer import Trainer
from playablevideogeneration_tpu_torch.utils.checkpoint import STATE_FILE
from playablevideogeneration_tpu_torch.utils.logging import Logger
from playablevideogeneration_tpu_torch.utils.pretrained import (
    load_variables_npz,
    make_metric_vgg,
    save_variables_npz,
)

SEED = 0
# configs/01_bair.yaml as a dict, since the card's machine has no PyYAML;
# tests/test_torch_data.py pins it to the file.
BAIR_LOSS_WEIGHTS = {}
for _name, _value in [("reconstruction_loss_lambda", 1.0), ("perceptual_loss_lambda", 1.0),
                      ("action_divergence_lambda", 0.0), ("states_rec_lambda", 0.2),
                      ("entropy_lambda", 0.0), ("action_directions_kl_lambda", 0.0001),
                      ("action_mutual_information_lambda", 0.15),
                      ("action_state_distribution_kl_lambda", 0.0)]:
    BAIR_LOSS_WEIGHTS[_name] = BAIR_LOSS_WEIGHTS[_name + "_pretraining"] = _value
BAIR_LOSS_WEIGHTS["hidden_states_rec_lambda_pretraining"] = 1.0
BAIR_CONFIG = {
    "logging": {"run_name": "01_bair", "output_root": "results", "save_root": "checkpoints"},
    "data": {"data_root": "data/bair_256_ours", "crop": [0, 0, 256, 256], "actions_count": 7,
             "ground_truth_available": False},
    "model": {
        "architecture": "model.main_model.model",
        "representation_network": {"target_input_size": [256, 256], "state_features": 64,
                                   "state_resolution": [32, 32]},
        "dynamics_network": {"hidden_state_size": 128, "embedding_mlp_size": 128,
                             "random_noise_size": 32},
        "rendering_network": {"input_shape": [64, 32, 32]},
        "action_network": {"use_gumbel": True, "hard_gumbel": False, "ensamble_size": 1,
                           "gumbel_temperature": 1.0, "action_space_dimension": 2},
        "centroid_estimator": {"alpha": 0.1},
    },
    "training": {
        "trainer": "training.smooth_mi_trainer", "use_ground_truth_actions": False,
        "learning_rate": 0.0004, "weight_decay": 0.000001, "pretraining_steps": 1000,
        "pretraining_detach": False, "lr_schedule": [300000, 10000000000], "lr_gamma": 0.3333,
        "max_steps": 300000, "save_freq": 3000, "ground_truth_observations_start": 6,
        "ground_truth_observations_end": 6, "ground_truth_observations_steps": 16000,
        "gumbel_temperature_start": 1.0, "gumbel_temperature_end": 0.4,
        "gumbel_temperature_steps": 20000, "mutual_information_estimation_alpha": 0.2,
        "batching": {"batch_size": 8, "observations_count": 12, "observations_count_start": 7,
                     "observations_count_steps": 25000, "skip_frames": 0,
                     "observation_stacking": 1, "num_workers": 16},
        "loss_weights": BAIR_LOSS_WEIGHTS,
        "action_direction_plotting_freq": 1000,
    },
    "evaluation": {
        "evaluator": "evaluation.evaluator", "max_evaluation_batches": 20, "eval_freq": 8000,
        "batching": {"batch_size": 8, "observations_count": 30, "skip_frames": 0,
                     "observation_stacking": 1, "num_workers": 16},
    },
    "evaluation_dataset": {"ground_truth_observations_init": 4,
                           "builder": "evaluation.evaluation_dataset_builder"},
    "tpu": {"compute_dtype": "bfloat16"},
}
# Phase 10's changes to BAIR_CONFIG, besides the data and output roots
# (loop_roots): a short run that saves and evaluates, with all three
# evaluation passes, since the synthetic videos carry their actions.
LOOP_OVERRIDES = {
    ("training", "pretraining_steps"): 2,
    ("training", "max_steps"): 6,
    ("training", "save_freq"): 3,
    ("evaluation", "eval_freq"): 6,
    ("evaluation", "max_evaluation_batches"): 2,
    ("data", "ground_truth_available"): True,
}
# Set after Configuration.check_config has derived the output paths: no
# example images, since the card's machine has no Pillow to write them.
CHECKED_OVERRIDES = {("logging", "output_images_directory"): None}
# Each CUDA kernel: its source and the Pallas TPU kernel (its
# pl.pallas_call) that it replaces.
KERNELS = {
    "convlstm_gates": ("convlstm_gates",
                       "playablevideogeneration_tpu/ops/pallas/convlstm_gates.py:119"),
    "convlstm_gates_bwd": ("convlstm_gates",
                           "playablevideogeneration_tpu/ops/pallas/convlstm_gates.py:134"),
    "fused_norm_act": ("fused_norm_act",
                       "playablevideogeneration_tpu/ops/pallas/fused_norm_act.py:71"),
}
ROLLOUT_FRAMES = 64
TIMED_STEPS = 60
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the
# f32 rate outside the tensor cores, which these elementwise kernels use.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per state element: 3 sigmoids (exp, add, reciprocal), 2 tanh,
# 3 multiplies and 1 add; and per element of the epilogue: multiply, add,
# select.
GATE_OPS_PER_ELEMENT = 3 * 3 + 2 + 4
NORM_OPS_PER_ELEMENT = 3
# The backward recomputes the forward (15) and adds 19 multiplies, adds and
# subtractions for d_c', the four gate gradients and dc_prev.
GATE_BWD_OPS_PER_ELEMENT = GATE_OPS_PER_ELEMENT + 19

# The flagship training step: batch 16, 12 frames, 11 dynamics steps.
TRAIN_BATCH, TRAIN_FRAMES = 16, 12
DYNAMICS_STEPS = TRAIN_FRAMES - 1
TRAIN_TIMED_STEPS = 5
# (B, C, H, W) of c at every K2 launch of one dynamics step, and the
# ragged case (65 channels, 25x40, batch 3).
GATE_TRAIN_SHAPES = [(TRAIN_BATCH, 128, 32, 32), (TRAIN_BATCH, 256, 16, 16),
                     (TRAIN_BATCH, 128, 32, 32)]  # lstm0, lstm1, lstm2
GATE_RAGGED_SHAPE = (3, 65, 25, 40)
# A C*H*W that is no multiple of a pack: one element per thread.
UNVECTORED_SHAPE = (3, 5, 7, 9)
# Shapes (B, C, H, W) at batch 1 of every launch in one flagship play step.
GATE_SHAPES = [(1, 128, 32, 32), (1, 256, 16, 16), (1, 128, 32, 32)]  # lstm0, lstm1, lstm2
NORM_SHAPES = [
    (1, 16, 128, 128), (1, 16, 128, 128),  # E: bn1, res0.bn1
    (1, 32, 64, 64), (1, 32, 64, 64),      # E: res1.bn1, res2.bn1
    (1, 64, 32, 32), (1, 64, 32, 32),      # E: res3.bn1, res4.bn1
    (1, 65, 32, 32),                       # E: res5.bn1 (state + attention)
    (1, 256, 16, 16), (1, 128, 16, 16),    # R: same0.bn1, up0.norm
    (1, 128, 32, 32),                      # R: same1.bn1
    (1, 128, 64, 64), (1, 128, 64, 64),    # D: up0.norm, res0.bn1
    (1, 64, 128, 128), (1, 64, 128, 128),  # D: up1.norm, res1.bn1
    (1, 32, 256, 256),                     # D: up2.norm
]
# Phase 10, the training loop on BAIR's config: batch 8, the first steps at
# 7 frames (the length anneals from 7 to 12 over 25 000 steps), evaluation
# at 8 x 30 frames from one ground-truth frame.
LOOP_BATCH, LOOP_FRAMES, EVAL_FRAMES = 8, 7, 30
LOOP_DYNAMICS_STEPS, EVAL_DYNAMICS_STEPS = LOOP_FRAMES - 1, EVAL_FRAMES - 1
GATE_LOOP_SHAPES = [(LOOP_BATCH, 128, 32, 32), (LOOP_BATCH, 256, 16, 16),
                    (LOOP_BATCH, 128, 32, 32)]  # lstm0, lstm1, lstm2


def eval_norm_shapes(batch: int, frames: int) -> list:
    """Every K3 launch of one evaluation forward (the model in eval mode,
    forward_full_model) of ``batch`` sequences of ``frames``: E encodes all
    batch*frames frames, A runs twice on as many states (the actions, then
    their re-estimate on the reconstruction), and each of the frames-1
    dynamics steps runs R, D and E (the window's re-encoding) at ``batch``,
    as the play step runs them at batch 1."""
    flat = batch * frames
    return ([(flat,) + s[1:] for s in NORM_SHAPES[:7]]        # E
            + [(flat, 128, 16, 16)] * 4                       # A: res0.bn1, res1.bn1, x2
            + [(batch,) + s[1:] for s in NORM_SHAPES[7:] + NORM_SHAPES[:7]]
            * (frames - 1))                                   # R, D, E per step


EVAL_NORM_SHAPES = eval_norm_shapes(LOOP_BATCH, EVAL_FRAMES)
EVAL_GATE_LAUNCHES = 3 * EVAL_DYNAMICS_STEPS
# Phase 11's f32 card-vs-CPU check: one builder batch of 2 sequences of 8
# frames (its K1 and K3 shapes are held bit for bit in phase 3).
PARITY_BATCH, PARITY_FRAMES = 2, 8
PARITY_NORM_SHAPES = eval_norm_shapes(PARITY_BATCH, PARITY_FRAMES)
GATE_PARITY_SHAPES = [(PARITY_BATCH,) + s[1:] for s in GATE_SHAPES]
# The synthetic videos: 32 frames at 256x256; 2 train videos give 52 samples
# at 7 frames (6 batches of 8), 6 validation videos 18 at 30 frames (2).
LOOP_VIDEO_FRAMES = 32
LOOP_VIDEOS = {"train": 2, "validation": 6, "test": 1}
LOOP_TIMED_STEPS = 8
# Phase 11, after training, on phase 10's run: a 64-frame scripted rollout
# of the play CLI, 11 interpolation factors x 4 frames, and the evaluation
# dataset of 2 builder batches of 8 test sequences of 30 frames (8 videos
# of 31 frames), evaluated at BAIR's evaluation batch of 1 x 30.
AFTER_ROLLOUT_FRAMES = 64
INTERPOLATION_FACTORS, INTERPOLATION_FRAMES = 11, 4
BUILDER_BATCHES = 2
TEST_VIDEOS, TEST_VIDEO_FRAMES = 8, EVAL_FRAMES + 1
# The reference checkpoint's per-gate ConvLSTM convolutions, in the order
# the port's fused gate convolution stacks them.
REFERENCE_GATES = ("input_gate", "forget_gate", "output_gate", "cell_gate")
LPIPS_CHANNELS = (64, 128, 256, 512, 512)
# configs/evaluation/01_bair.yaml as a dict, since the card's machine has no
# PyYAML; tests/test_torch_offline_eval.py pins it to the file.
BAIR_EVALUATION_CONFIG = {
    "logging": {"run_name": "01_bair", "comments": "", "output_root": "evaluation_results"},
    "data": {"target_input_size": [256, 256], "actions_count": 7,
             "ground_truth_available": False},
    "reference_data": {"data_root": "data/bair_256_ours/test", "crop": [0, 0, 256, 256]},
    "generated_data": {"data_root": "results/01_bair/evaluation_dataset",
                       "crop": [0, 0, 256, 256]},
    "evaluation": {"evaluator": "evaluation.dataset_evaluator_bair",
                   "batching": {"batch_size": 1, "observations_count": 30, "skip_frames": 0,
                                "observation_stacking": 1, "num_workers": 8}},
}
# Cold timings rotate over distinct inputs totalling at least this much,
# three times the 50 MB L2, so that each launch finds its inputs in HBM.
COLD_BYTES = 150e6
# Kernel-name fragments that sort the profiled step's device time.
KERNEL_GROUPS = [
    ("port_kernels", ("gates_fwd_kernel", "gates_bwd_kernel",
                      "batch_norm_leaky_relu_kernel")),
    ("layout_transpose", ("nchwToNhwc", "nhwcToNchw", "tensorTransform")),
    ("convolution", ("fprop", "dgrad", "wgrad", "xmma", "winograd", "cutlass", "gemm",
                     "conv")),
    ("upsample", ("upsample",)),
    ("pooling", ("pool",)),
    ("batch_norm", ("batch_norm",)),
    ("reduction", ("reduce",)),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("copy_cast", ("copy",)),
    ("elementwise", ("elementwise",)),
]
TOLERANCE = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def require(condition: bool, message) -> None:
    if not condition:
        raise RuntimeError(message)


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def loop_roots(root: str) -> dict:
    return {("data", "data_root"): os.path.join(root, "data"),
            ("logging", "output_root"): os.path.join(root, "results"),
            ("logging", "save_root"): os.path.join(root, "checkpoints")}


def loop_config(root: str) -> dict:
    """Phase 10's checked run config: BAIR_CONFIG with LOOP_OVERRIDES and
    its outputs under ``root``."""
    config = copy.deepcopy(BAIR_CONFIG)
    for (section, key), value in {**LOOP_OVERRIDES, **loop_roots(root)}.items():
        config[section][key] = value
    Configuration(config=config).check_config(check_data_root=False)
    for (section, key), value in CHECKED_OVERRIDES.items():
        config[section][key] = value
    return config


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def device_ms(fn, launches: int = 50, repeats: int = 5) -> float:
    """Median device time of one call of ``fn``: CUDA events around
    ``launches`` calls queued behind a sleep kernel, so that the host's
    issue rate does not show in the device's time.  A measurement in which
    the device reached the first call before the host had queued the last
    one is discarded and taken again behind a longer sleep.  ``fn`` must
    launch well under the ~1000 kernels the device's queue holds, or the
    host blocks on the full queue and the measurement raises."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    sleep_cycles = 10_000_000
    times = []
    while len(times) < repeats:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        starved = start.query()
        end.synchronize()
        if starved:
            sleep_cycles *= 2
            require(sleep_cycles <= 320_000_000,
                    "the host cannot queue the launches ahead of the device")
        else:
            times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def bound_ms(bytes_moved: float, operations: float):
    byte_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    op_ms = operations / F32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def on_card(shape, dtype, gen, scale: float = 1.0, offset: int = 0) -> torch.Tensor:
    """Seeded N(0, scale^2) values in ``dtype``: a contiguous tensor, or
    with ``offset`` a contiguous view whose storage starts that many
    elements into its buffer."""
    values = (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)
    if not offset:
        return values
    view = torch.empty(values.numel() + offset, dtype=dtype, device="cuda")[offset:]
    return view.view(shape).copy_(values)


def gate_inputs(shape, dtype, gen, offset: int = 0):
    b, c, h, w = shape
    return on_card((b, 4 * c, h, w), dtype, gen, 2.0, offset), on_card(shape, dtype, gen, 1.0,
                                                                       offset)


def gate_backward_inputs(shape, dtype, gen):
    return gate_inputs(shape, dtype, gen) + tuple(on_card(shape, dtype, gen)
                                                  for _ in range(2))  # dh, dc


def norm_inputs(shape, dtype, gen, offset: int = 0):
    """x and the BatchNorm's raw statistics: scale, bias, mean, var."""
    c = shape[1]
    x = on_card(shape, dtype, gen, 1.0, offset)
    scale = torch.rand(c, generator=gen, device="cuda") + 0.5
    bias = torch.randn(c, generator=gen, device="cuda") * 0.1
    mean = torch.randn(c, generator=gen, device="cuda") * 0.1
    var = torch.rand(c, generator=gen, device="cuda") * 1.5 + 0.5
    return x, scale, bias, mean, var


def unique(shapes):
    return list(dict.fromkeys(shapes))


def compare(name, shape, dtype, got, want) -> float:
    """Holds a kernel's outputs against its plain version's: the stated
    tolerance for the message, then bit for bit; returns the largest
    difference."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        require(g.dtype == dtype and g.shape == w.shape, (name, shape))
        torch.testing.assert_close(g.float(), w.float(), **TOLERANCE[dtype],
                                   msg=lambda m: f"{name} {shape} {dtype}: {m}")
        require(torch.equal(g, w), f"{name} {shape} {dtype} is not bit-exact")
        err = max(err, (g.float() - w.float()).abs().max().item())
    return err


def check_kernels(gen) -> dict:
    """Phase 3, K1 and K3; returns the largest error of each kernel.  The
    unvectored shape and the views that start one element into their
    buffers must run one element per thread, and each kernel must run
    packs at some flagship shape in each dtype."""
    errors = {"convlstm_gates": 0.0, "fused_norm_act": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        cases = [("convlstm_gates", s, o, gate_inputs(s, dtype, gen, o), fused_lstm_gates,
                  _gate_math)
                 for s, o in [(s, 0) for s in unique(GATE_SHAPES + GATE_TRAIN_SHAPES
                                                     + GATE_LOOP_SHAPES + GATE_PARITY_SHAPES)]
                 + [(GATE_RAGGED_SHAPE, 0), (UNVECTORED_SHAPE, 0), (GATE_SHAPES[0], 1)]]
        cases += [("fused_norm_act", s, o, norm_inputs(s, dtype, gen, o),
                   fused_batch_norm_leaky_relu, _batch_norm_leaky_relu)
                  for s, o in [(s, 0) for s in unique(NORM_SHAPES + EVAL_NORM_SHAPES
                                                      + PARITY_NORM_SHAPES)]
                  + [(UNVECTORED_SHAPE, 0), (NORM_SHAPES[2], 1)]]
        widths = {name: set() for name in errors}
        for name, shape, offset, args, kernel, plain in cases:
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            err = compare(name, shape, dtype, got, want)
            errors[name] = max(errors[name], err)
            # The width the wrapper chose: K1 walks C*H*W of c and gates in
            # packs of GATE_PACK, K3 H*W of x in 16-byte packs.
            if name == "convlstm_gates":
                width = build.vector_width(math.prod(shape[1:]), args[1], args[0],
                                           elements=GATE_PACK)
            else:
                width = build.vector_width(math.prod(shape[2:]), args[0],
                                           elements=16 // args[0].element_size())
            require(width == 1 or not (offset or shape == UNVECTORED_SHAPE),
                    f"{name} {shape} offset {offset}: vector width {width}")
            widths[name].add(width)
            emit(phase="kernel_check", kernel=name, shape=shape, storage_offset=offset,
                 dtype=DTYPE_NAMES[dtype], vector_width=width, max_abs_err=err)
        require(all(w - {1} for w in widths.values()), f"{dtype}: vector widths {widths}")
    return errors


def check_gate_backward(gen) -> float:
    """Phase 3, K2: returns its largest error against ``_gate_math_bwd``."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in unique(GATE_TRAIN_SHAPES + GATE_LOOP_SHAPES) + [GATE_RAGGED_SHAPE]:
            args = gate_backward_inputs(shape, dtype, gen)
            got, want = fused_lstm_gates_bwd(*args), _gate_math_bwd(*args)
            torch.cuda.synchronize()
            err = compare("gate_bwd", shape, dtype, got, want)
            worst = max(worst, err)
            emit(phase="kernel_check", kernel="convlstm_gates_bwd", shape=shape,
                 dtype=DTYPE_NAMES[dtype], max_abs_err=err)
    # The autograd function (K1 forward, K2 backward) against autograd
    # through the plain gate math, which differentiates sigmoid and tanh
    # in its own order of operations: 1e-5 in f32.
    gates, c, dh, dc = gate_backward_inputs(GATE_RAGGED_SHAPE, torch.float32, gen)
    grads = []
    for fn in (fused_lstm_gates, _gate_math):
        g, cell = gates.clone().requires_grad_(), c.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(g, cell), (g, cell), (dh, dc)))
    err = max((a - b).abs().max().item() for a, b in zip(*grads))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    emit(phase="autograd_check", function="_FusedGates", shape=GATE_RAGGED_SHAPE,
         dtype="f32", max_abs_err=err, tolerance=1e-5)
    return worst


def check_frame(frame: np.ndarray, shape) -> None:
    require(frame.shape == shape, frame.shape)
    require(np.isfinite(frame).all(), "non-finite frame")
    require(frame.min() >= -1.0 and frame.max() <= 1.0, (frame.min(), frame.max()))


@contextlib.contextmanager
def counted_syncs():
    """Yields a list that receives, when the block ends, the message of
    every synchronising CUDA operation the block ran."""
    syncs = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield syncs
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs.extend(str(w.message) for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message))


def play_route(model, obs: np.ndarray, actions: np.ndarray) -> dict:
    """Phase 4 on the bf16 flagship; returns the launch counts."""
    session = PlaySession(model)
    reset_launches()
    session.start(obs)
    frames = [session.generate_next(int(a)) for a in actions[:3]]
    u8 = session.generate_next_u8(int(actions[3]))
    frames.append(session.generate_next_interpolation(0, 3, 0.7))
    with counted_syncs() as syncs:
        rollout = session.rollout(actions[:ROLLOUT_FRAMES])
    launches = read_launches()
    steps = 3 + 1 + 1 + ROLLOUT_FRAMES
    require(launches == {"convlstm_gates": 3 * steps, "convlstm_gates_bwd": 0,
                         "fused_norm_act": 15 * steps}, f"{steps} steps launched {launches}")
    for frame in frames:
        check_frame(frame, (256, 256, 3))
    require(u8.dtype == np.uint8 and u8.shape == (256, 256, 3), (u8.dtype, u8.shape))
    require(rollout.dtype == np.uint8 and rollout.shape == (ROLLOUT_FRAMES, 256, 256, 3),
            (rollout.dtype, rollout.shape))
    require(len(syncs) == 1, f"rollout synchronised {len(syncs)} times: {syncs}")
    require(rollout.std() > 0, "constant rollout")
    emit(phase="play_route", steps=steps, launches=launches, rollout_syncs=len(syncs),
         frame_min=float(min(f.min() for f in frames)),
         frame_max=float(max(f.max() for f in frames)),
         rollout_mean=float(rollout.mean()), rollout_std=float(rollout.std()))
    return launches


def route_parity(obs: np.ndarray, actions: np.ndarray) -> float:
    """Phase 5: f32 through the kernels on the card vs the plain path on
    the CPU, same seeded weights; returns the largest frame difference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = PlaySession(flagship_model("cuda", torch.float32, SEED)).start(obs)
    cpu = PlaySession(flagship_model("cpu", torch.float32, SEED)).start(obs)
    before = fused_lstm_gates.launches, fused_batch_norm_leaky_relu.launches
    err = 0.0
    for a in actions[:3]:
        got, want = gpu.generate_next(int(a)), cpu.generate_next(int(a))
        check_frame(got, (256, 256, 3))
        err = max(err, float(np.abs(got - want).max()))
    counts = (fused_lstm_gates.launches - before[0],
              fused_batch_norm_leaky_relu.launches - before[1])
    require(counts == (9, 45), f"f32 route launched {counts}, not (9, 45)")
    for (gh, gc), (ch, cc) in zip(gpu.carry, cpu.carry):
        err = max(err, (gh.cpu() - ch).abs().max().item(), (gc.cpu() - cc).abs().max().item())
    require(err <= 1e-3, f"f32 route differs from the CPU plain path by {err}")
    emit(phase="route_parity", dtype="f32", tf32=False, steps=3, max_abs_err=err,
         tolerance=1e-3)
    return err


def kernel_time(name, shape, kernel, plain, make_args, bytes_moved, operations) -> dict:
    """Device time of one bf16 launch at ``shape``, warm (the same inputs
    back to back, in L2) and cold (rotating over distinct input sets that
    total ``COLD_BYTES``, so that each launch reads its inputs from HBM),
    beside the bound and the plain version's warm time; emits them."""
    args = make_args()
    bound, bound_by = bound_ms(bytes_moved, operations)
    ms = device_ms(lambda: kernel(*args))
    sets = [args] + [make_args() for _ in range(math.ceil(COLD_BYTES / bytes_moved))]
    turn = itertools.cycle(sets)
    cold_ms = device_ms(lambda: kernel(*next(turn)))
    del sets, turn
    plain_ms = device_ms(lambda: plain(*args), launches=20)
    emit(phase="kernel_time", kernel=name, shape=shape, dtype="bf16", us=ms * 1e3,
         cold_us=cold_ms * 1e3, bound_us=bound * 1e3, bound_by=bound_by,
         plain_us=plain_ms * 1e3, bound_share_cold=bound / cold_ms)
    return dict(ms=ms, cold_ms=cold_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)


def add_to(sums: dict, name: str, times: dict, count: int = 1) -> None:
    total = sums.setdefault(name, dict(ms=0.0, cold_ms=0.0, plain_ms=0.0, bound_ms=0.0))
    for key in ("ms", "cold_ms", "plain_ms", "bound_ms"):
        total[key] += times[key] * count
    total["bound_by"] = times["bound_by"]


def time_kernels(gen) -> dict:
    """Phase 6a: device times, bound and plain time of every launch of one
    bf16 play step; returns per-kernel sums over the step."""
    dtype = torch.bfloat16
    size = 2  # bytes per bf16 element
    sums = {}
    # Per state element K1 reads 4 gates and c and writes h' and c'; per
    # element K3 reads x and writes y, and it reads 16 bytes per channel
    # of statistics (scale, bias, mean, var).
    for shape in unique(GATE_SHAPES):
        elements = math.prod(shape)
        times = kernel_time("convlstm_gates", shape, fused_lstm_gates, _gate_math,
                            lambda: gate_inputs(shape, dtype, gen), elements * 7 * size,
                            elements * GATE_OPS_PER_ELEMENT)
        add_to(sums, "convlstm_gates", times, GATE_SHAPES.count(shape))
    for shape in unique(NORM_SHAPES):
        elements = math.prod(shape)
        times = kernel_time("fused_norm_act", shape, fused_batch_norm_leaky_relu,
                            _batch_norm_leaky_relu, lambda: norm_inputs(shape, dtype, gen),
                            elements * 2 * size + 16 * shape[1],
                            elements * NORM_OPS_PER_ELEMENT)
        add_to(sums, "fused_norm_act", times, NORM_SHAPES.count(shape))
    return sums


def time_loop_kernels(gen) -> None:
    """Phase 6c: K1 and K2 at the loop's batch of 8, and K3 at the three
    largest shapes of an evaluation batch (bf16, warm and cold)."""
    dtype, size = torch.bfloat16, 2
    for shape in unique(GATE_LOOP_SHAPES):
        elements = math.prod(shape)
        kernel_time("convlstm_gates", shape, fused_lstm_gates, _gate_math,
                    lambda: gate_inputs(shape, dtype, gen), elements * 7 * size,
                    elements * GATE_OPS_PER_ELEMENT)
        kernel_time("convlstm_gates_bwd", shape, fused_lstm_gates_bwd, _gate_math_bwd,
                    lambda: gate_backward_inputs(shape, dtype, gen), elements * 12 * size,
                    elements * GATE_BWD_OPS_PER_ELEMENT)
    for shape in sorted(unique(EVAL_NORM_SHAPES), key=math.prod, reverse=True)[:3]:
        elements = math.prod(shape)
        kernel_time("fused_norm_act", shape, fused_batch_norm_leaky_relu,
                    _batch_norm_leaky_relu, lambda: norm_inputs(shape, dtype, gen),
                    elements * 2 * size + 16 * shape[1], elements * NORM_OPS_PER_ELEMENT)


def time_route(model, obs: np.ndarray, actions: np.ndarray) -> dict:
    """Phase 6b: play-step latency, rollout frame rate and the step's
    device-time breakdown on the bf16 flagship."""
    from torch.profiler import ProfilerActivity, profile

    session = PlaySession(model).start(obs)
    onehot = torch.eye(model.actions_count, device="cuda")[:1]
    variation = torch.zeros(1, model.action_space_dimension, device="cuda")
    carry, window = session.carry, session.window
    step_ms = []
    for i in range(TIMED_STEPS + 5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, _, window = model.play_step(carry, window, onehot, variation)
        torch.cuda.synchronize()
        if i >= 5:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    interactive_ms = []
    for i in range(TIMED_STEPS + 5):
        t0 = time.perf_counter()
        session.generate_next_u8(int(actions[i % len(actions)]))
        if i >= 5:
            interactive_ms.append((time.perf_counter() - t0) * 1e3)
    rollout_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.rollout(actions[:ROLLOUT_FRAMES])
        rollout_s.append(time.perf_counter() - t0)

    steps = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            model.play_step(carry, window, onehot, variation)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = sorted(((e.key, e.device_time_total / steps / 1e3, e.count / steps)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels) if kernels else None
    play_step_ms = statistics.median(step_ms)
    # The idle share sets the profiled device time against the unprofiled
    # step, since the profiler slows the host.
    route = dict(play_step_ms=play_step_ms,
                 play_step_p90_ms=float(np.percentile(step_ms, 90)),
                 interactive_u8_ms=statistics.median(interactive_ms),
                 rollout_fps=ROLLOUT_FRAMES / statistics.median(rollout_s),
                 profiled_step_wall_ms=wall_ms, step_device_busy_ms=busy_ms,
                 device_idle_share=None if busy_ms is None else 1 - busy_ms / play_step_ms,
                 kernels_per_step=sum(k[2] for k in kernels))
    emit(phase="route_time", dtype="bf16", **route)
    emit(phase="step_breakdown", **breakdown(kernels, 20))
    return route


def reset_launches() -> None:
    fused_lstm_gates.launches = 0
    fused_lstm_gates_bwd.launches = 0
    fused_batch_norm_leaky_relu.launches = 0


def read_launches() -> dict:
    return {"convlstm_gates": fused_lstm_gates.launches,
            "convlstm_gates_bwd": fused_lstm_gates_bwd.launches,
            "fused_norm_act": fused_batch_norm_leaky_relu.launches}


def flagship_trainer() -> Trainer:
    return build_synthetic_trainer(
        height=256, width=256, batch_size=TRAIN_BATCH, observations_count=TRAIN_FRAMES,
        compute_dtype="bfloat16", remat=True, smooth_mi=True, pretraining_steps=1,
        device="cuda", seed=SEED)


def device_batch(batch):
    return type(batch)(*(torch.as_tensor(x, device="cuda") for x in batch))


def train_route(trainer: Trainer, batch) -> dict:
    """Phase 7: one pretraining and three full-phase steps of the bf16
    flagship trainer; returns the launch counts summed over the steps."""
    def by_module():
        return {name: torch.cat([p.detach().flatten().clone() for p in module.parameters()])
                for name, module in trainer.model.named_children()}

    before = by_module()
    expected = {"convlstm_gates": 6 * DYNAMICS_STEPS, "convlstm_gates_bwd": 3 * DYNAMICS_STEPS,
                "fused_norm_act": 0}
    totals = dict.fromkeys(expected, 0)
    for step in range(4):
        reset_launches()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        launches = read_launches()
        require(launches == expected, f"train step {step + 1} launched {launches}")
        for name, count in launches.items():
            totals[name] += count
        require(metrics["pretraining"] == float(step == 0), metrics["pretraining"])
        norms = {k: v for k, v in metrics.items() if k.startswith("grad_norm/")}
        require(np.isfinite(metrics["loss"]) and all(np.isfinite(v) for v in norms.values()),
                f"step {step + 1}: loss {metrics['loss']}, norms {norms}")
        require(norms["grad_norm/global"] > 0, norms)
        emit(phase="train_step", step=step + 1, pretraining=bool(metrics["pretraining"]),
             loss=metrics["loss"], ground_truth_observations=metrics["ground_truth_observations"],
             gumbel_temperature=metrics["gumbel_temperature"], launches=launches, **norms)
    after = by_module()
    changed = {name: float((after[name] - before[name]).abs().max()) for name in before}
    require(all(v > 0 for v in changed.values()), f"parameters unchanged: {changed}")
    emit(phase="train_route", steps=4, launches=totals, max_parameter_change=changed)
    return totals


def train_parity() -> dict:
    """Phase 8: one f32 full-phase step at full width on the card and on
    the CPU, same weights, same batch, same noise (one CPU generator each,
    seeded alike).  Both models checkpoint each step, as the bf16 route
    does, so the card's recompute (K1 relaunched under
    ``torch.utils.checkpoint``, the frozen BatchNorm statistics, K2 on the
    recomputed residuals) is held against the CPU's plain versions."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = make_synthetic_config(
        height=256, width=256, actions_count=7, batch_size=2, observations_count=4,
        observation_stacking=1, hidden_state_size=128, state_features=64,
        pretraining_steps=0, compute_dtype="float32")
    config["training"]["ground_truth_observations_start"] = 2
    config["training"]["ground_truth_observations_end"] = 2
    batch = make_synthetic_batch(batch_size=2, observations_count=4, height=256, width=256,
                                 seed=SEED)
    results = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(config, flagship_model(device, torch.float32, SEED,
                                                 checkpoint_steps=True),
                          smooth_mi=True, seed=SEED)
        trainer.init_state()
        trainer.generator = torch.Generator().manual_seed(SEED)
        reset_launches()
        results[device] = trainer.train_step(batch)
        if device == "cuda":
            torch.cuda.synchronize()
            launches = read_launches()
    # T=4 gives 3 dynamics steps: K1 in the forward and again in the
    # recompute, K2 once.
    require(launches == {"convlstm_gates": 18, "convlstm_gates_bwd": 9, "fused_norm_act": 0},
            f"train parity launched {launches}")
    got, want = results["cuda"], results["cpu"]
    require(got["ground_truth_observations"] == 2, got["ground_truth_observations"])
    terms = [k for k in want if not k.startswith("grad_norm/")
             and k not in ("ground_truth_observations", "gumbel_temperature",
                           "observations_count", "lr", "pretraining")]
    norms = [k for k in want if k.startswith("grad_norm/")]
    errors = {}
    for keys, rtol in ((terms, 1e-3), (norms, 1e-2)):
        for k in keys:
            errors[k] = abs(got[k] - want[k]) / max(abs(want[k]), 1e-5)
            require(np.isfinite(got[k]) and errors[k] <= rtol,
                    f"train parity {k}: card {got[k]} vs CPU {want[k]}")
    emit(phase="train_parity", dtype="f32", tf32=False, batch=2, frames=4, checkpointed=True,
         launches=launches,
         ground_truth_observations=2, loss_card=got["loss"], loss_cpu=want["loss"],
         max_rel_err_terms=max(errors[k] for k in terms),
         max_rel_err_grad_norms=max(errors[k] for k in norms),
         tolerance_terms=1e-3, tolerance_grad_norms=1e-2,
         grad_norms_card={k: got[k] for k in norms}, grad_norms_cpu={k: want[k] for k in norms})
    return errors


def time_gate_kernels_in_training(gen) -> dict:
    """Phase 9a: K1's and K2's device times, bound and plain time per launch
    at the training shapes (bf16); returns K2's sums over one training
    step (K1's summary stays that of the play step)."""
    dtype, size = torch.bfloat16, 2
    total = {}
    for shape in unique(GATE_TRAIN_SHAPES):
        elements = math.prod(shape)
        # Per state element K1 reads 4 gates and c and writes h' and c'; K2
        # reads 4 gates, c, dh and dc and writes 4 gate gradients and
        # dc_prev.
        kernel_time("convlstm_gates", shape, fused_lstm_gates, _gate_math,
                    lambda: gate_inputs(shape, dtype, gen), elements * 7 * size,
                    elements * GATE_OPS_PER_ELEMENT)
        times = kernel_time("convlstm_gates_bwd", shape, fused_lstm_gates_bwd, _gate_math_bwd,
                            lambda: gate_backward_inputs(shape, dtype, gen),
                            elements * 12 * size, elements * GATE_BWD_OPS_PER_ELEMENT)
        add_to(total, "convlstm_gates_bwd", times,
               GATE_TRAIN_SHAPES.count(shape) * DYNAMICS_STEPS)
    return total["convlstm_gates_bwd"]


def time_train(trainer: Trainer, batch) -> dict:
    """Phase 9b: median full-phase train step, frames per second, peak
    memory, and the device's busy share over two profiled steps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = sorted(((e.key, e.device_time_total / steps / 1e3, e.count / steps)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels) if kernels else None
    train_step_ms = statistics.median(step_ms)
    route = dict(train_step_ms=train_step_ms, train_step_ms_all=step_ms,
                 train_frames_per_sec=TRAIN_BATCH * TRAIN_FRAMES / (train_step_ms / 1e3),
                 train_batch_size=TRAIN_BATCH, train_frames=TRAIN_FRAMES,
                 peak_memory_gib=peak_gib, profiled_step_wall_ms=wall_ms,
                 step_device_busy_ms=busy_ms,
                 device_idle_share=None if busy_ms is None else 1 - busy_ms / train_step_ms,
                 kernels_per_step=sum(k[2] for k in kernels))
    emit(phase="train_time", dtype="bf16", **route)
    emit(phase="train_step_breakdown", **breakdown(kernels, 25))
    return route


def loop_datasets(config: dict) -> dict:
    """Each split's synthetic moving-square videos (LOOP_VIDEOS of 32 frames
    at the config's size, seeded), held in memory, so no Pillow is needed."""
    width, height = config["model"]["representation_network"]["target_input_size"]
    transforms = get_final_transforms(config)
    batching = {"train": config["training"]["batching"],
                "validation": config["evaluation"]["batching"],
                "test": config["evaluation"]["batching"]}
    datasets, seed = {}, SEED
    for name, count in LOOP_VIDEOS.items():
        videos = [make_moving_square_video(LOOP_VIDEO_FRAMES, height, width, square=height // 8,
                                           actions_count=config["data"]["actions_count"],
                                           seed=seed + i, step_pixels=height // 20)
                  for i in range(count)]
        seed += count
        datasets[name] = VideoDataset.from_videos(videos, batching[name], transforms[name])
    return datasets


def launches_since(before: dict) -> dict:
    return {name: count - before[name] for name, count in read_launches().items()}


class LoopRecorder:
    """Within the block, every ``Trainer.train_step``, evaluation forward
    and evaluation pass is recorded: its kernel launches, wall time and
    metrics, and for a step the schedules' values at its global step."""

    def __enter__(self):
        self.steps, self.forwards, self.passes = [], [], []
        self._saved = Trainer.train_step, Evaluator._forward, Evaluator.evaluate
        train_step, forward, evaluate = self._saved
        steps, forwards, passes = self.steps, self.forwards, self.passes

        def recorded_step(trainer, batch):
            before, start = read_launches(), time.perf_counter()
            metrics = train_step(trainer, batch)  # ends in a device-to-host transfer
            seconds = time.perf_counter() - start
            length = trainer.get_observations_count()
            steps.append(dict(
                step=trainer.global_step, start=start, seconds=seconds,
                launches=launches_since(before), metrics=dict(metrics),
                schedules=dict(observations_count=length, gumbel_temperature=(
                    trainer.get_gumbel_temperature()), ground_truth_observations=min(
                    trainer.get_ground_truth_observations_count(), length - 1))))
            return metrics

        def recorded_forward(evaluator, observations, actions, generator):
            before = read_launches()
            out = forward(evaluator, observations, actions, generator)
            forwards.append(dict(label=evaluator._sampler_label,
                                 frames=tuple(observations.shape[:2]),
                                 launches=launches_since(before)))
            return out

        def recorded_evaluate(evaluator, step, save_images=True):
            start, first = time.perf_counter(), len(forwards)
            metrics = evaluate(evaluator, step, save_images)  # each batch read back
            passes.append(dict(label=evaluator._sampler_label,
                               seconds=time.perf_counter() - start,
                               batches=len(forwards) - first, metrics=metrics))
            return metrics

        Trainer.train_step = recorded_step
        Evaluator._forward = recorded_forward
        Evaluator.evaluate = recorded_evaluate
        return self

    def __exit__(self, *exc_info):
        Trainer.train_step, Evaluator._forward, Evaluator.evaluate = self._saved


def state_snapshot(trainer: Trainer) -> dict:
    """The training state, copied to the host: parameters and buffers,
    Adam's slots and groups, the schedule, the MI matrix, the steps."""
    optimizer = trainer.state.optimizer.state_dict()
    return dict(
        model={k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()},
        adam={(i, name): v.detach().cpu().clone() for i, slots in optimizer["state"].items()
              for name, v in slots.items()},
        param_groups=optimizer["param_groups"], scheduler=trainer.state.scheduler.state_dict(),
        mi_matrix=trainer.state.mi_matrix.cpu().clone(), step=trainer.state.step,
        global_step=trainer.global_step)


def require_same_state(got: dict, want: dict) -> None:
    for part in ("model", "adam"):
        require(got[part].keys() == want[part].keys(), f"{part}: different entries")
        for key, value in want[part].items():
            require(torch.equal(got[part][key], value), f"{part} {key} differs")
    for key in ("param_groups", "scheduler", "step", "global_step"):
        require(got[key] == want[key], f"{key}: {got[key]} != {want[key]}")
    require(torch.equal(got["mi_matrix"], want["mi_matrix"]), "the MI matrix differs")


def check_loop_steps(steps: list, pretraining_steps: int) -> None:
    """Every recorded step: finite loss and gradient norms, its phase, the
    schedules' values at its global step, and K1 and K2 3(T-1) times each
    (one launch per ConvLSTM per dynamics step, forward and backward; no
    per-step checkpointing in BAIR's config), K3 never."""
    for record in steps:
        metrics, step = record["metrics"], record["step"]
        length = metrics["observations_count"]
        require(np.isfinite(metrics["loss"])
                and all(np.isfinite(v) for k, v in metrics.items() if k.startswith("grad_norm/")),
                f"step {step}: {metrics}")
        require(metrics["pretraining"] == float(step <= pretraining_steps), (step, metrics))
        for key, value in record["schedules"].items():
            require(metrics[key] == value, f"step {step}: {key} {metrics[key]} != {value}")
        want = {"convlstm_gates": 3 * (length - 1), "convlstm_gates_bwd": 3 * (length - 1),
                "fused_norm_act": 0}
        require(record["launches"] == want, f"step {step} launched {record['launches']}")
        emit(phase="loop_step", step=step, pretraining=bool(metrics["pretraining"]),
             frames=length, ground_truth_observations=metrics["ground_truth_observations"],
             gumbel_temperature=metrics["gumbel_temperature"], loss=metrics["loss"],
             seconds=record["seconds"], launches=record["launches"])


def check_evaluation(recorder: LoopRecorder) -> None:
    """The three passes of the cli's evaluation: each batch's forward
    launches K1 3 times per dynamics step and K3 once per frozen BatchNorm
    + LeakyReLU (``EVAL_NORM_SHAPES``: 446 at 8 x 30 frames), K2 never;
    finite metrics; one-hot samples carry no entropy, and the ground-truth
    sampler, mapped through the Hungarian matching, scores its own
    accuracy."""
    want = {"convlstm_gates": EVAL_GATE_LAUNCHES, "convlstm_gates_bwd": 0,
            "fused_norm_act": len(EVAL_NORM_SHAPES)}
    require(len(recorder.forwards) == 6, f"{len(recorder.forwards)} evaluation forwards")
    for forward in recorder.forwards:
        require(forward["frames"] == (LOOP_BATCH, EVAL_FRAMES), forward)
        require(forward["launches"] == want, f"evaluation batch launched {forward['launches']}")
    require([p["label"] for p in recorder.passes] == [None, "one_hot", "gt_actions"],
            recorder.passes)
    for record in recorder.passes:
        metrics = record["metrics"]
        require(record["batches"] == 2 and metrics
                and all(np.isfinite(v) for v in metrics.values()), record)
        prefix = "validation" + (f"/{record['label']}" if record["label"] else "")
        emit(phase="loop_evaluation", sampler=record["label"] or "gumbel",
             seconds=record["seconds"], batches=record["batches"],
             seconds_per_batch=record["seconds"] / record["batches"],
             launches_per_batch=want,
             actions_accuracy=metrics[f"{prefix}/actions_accuracy"],
             samples_entropy=metrics[f"{prefix}/samples_entropy"],
             observations_loss=metrics[f"{prefix}/observations_loss/avg"],
             perceptual_loss=metrics[f"{prefix}/perceptual_loss/avg"])
    one_hot, gt = recorder.passes[1]["metrics"], recorder.passes[2]["metrics"]
    require(one_hot["validation/one_hot/samples_entropy"] < 1e-5, one_hot)
    require(gt["validation/gt_actions/actions_accuracy"] > 0.999, gt)


def train_loop(root: str) -> dict:
    """Phase 10: BAIR's config (LOOP_OVERRIDES) through ``cli.train.train``
    on in-memory synthetic videos: 2 pretraining and 4 full-phase steps,
    checkpoints, the three evaluation passes; the state restored exactly by
    a fresh run; a resumed run's 2 more steps; then, on the evaluated
    trainer, two profiled loop steps and bare ``train_step``s.  Returns the
    two runs' launch counts."""
    from torch.profiler import ProfilerActivity, profile

    # The defaults, which phases 5 and 8 turned off: a run's f32
    # convolutions (the evaluator's VGG) take TF32.
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    config = loop_config(root)
    pretraining_steps = config["training"]["pretraining_steps"]
    datasets = loop_datasets(config)
    for name, frames, batches in (("train", LOOP_FRAMES, 6), ("validation", EVAL_FRAMES, 2)):
        datasets[name].set_observations_count(frames)
        require(len(datasets[name]) // LOOP_BATCH >= batches, (name, len(datasets[name])))

    with LoopRecorder() as recorder:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        trainer = train(config, device="cuda", datasets=datasets)
        torch.cuda.synchronize()
        launches = read_launches()
        loop_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        require([r["step"] for r in recorder.steps] == list(range(1, 7)), recorder.steps)
        check_evaluation(recorder)

        save_root = config["logging"]["save_root_directory"]
        require(sorted(os.listdir(save_root)) == ["checkpoint_6", "latest"],
                os.listdir(save_root))
        saved = state_snapshot(trainer)  # the evaluation must have changed nothing
        start = time.perf_counter()
        trainer.save_checkpoint("timed")
        save_s = time.perf_counter() - start
        checkpoint_bytes = os.path.getsize(os.path.join(save_root, "timed", STATE_FILE))
        _, _, restored, _, _ = build_run(config, device="cuda", datasets=datasets)
        restored.init_state()
        torch.cuda.synchronize()
        start = time.perf_counter()
        restored.load_checkpoint()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - start
        require_same_state(state_snapshot(restored), saved)
        del restored
        emit(phase="loop_checkpoint", bytes=checkpoint_bytes, save_s=save_s, load_s=load_s,
             restored_exactly=True)

        reset_launches()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            resumed = train(config, max_steps=8, device="cuda", datasets=datasets)
        torch.cuda.synchronize()
        sys.stdout.write(printed.getvalue())
        for name, count in read_launches().items():
            launches[name] += count
        require("- Resuming from checkpoint" in printed.getvalue(), "the second run did not resume")
        require(resumed.global_step == 8 and [r["step"] for r in recorder.steps[6:]] == [7, 8],
                (resumed.global_step, [r["step"] for r in recorder.steps]))
        del resumed

        # On the evaluated trainer: two loop steps under the profiler, then
        # bare train_steps on one of its batches, on the device and on the
        # host as the loader gives it.
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            trainer.train_epoch(max_steps=trainer.global_step + 2)
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - start) * 1e3 / 2
        batch = next(iter(trainer.dataloader))
        on_device = SimpleNamespace(
            observations=torch.as_tensor(batch.observations, device=trainer.device),
            actions=torch.as_tensor(batch.actions, device=trainer.device))
        torch.cuda.reset_peak_memory_stats()
        bare_ms = {"device_batch": [], "host_batch": []}
        for i in range(LOOP_TIMED_STEPS + 1):  # in turns; the first of each warms up
            for name, bare in (("device_batch", on_device), ("host_batch", batch))[::(-1) ** i]:
                trainer.train_step(bare)
                if i:
                    bare_ms[name].append(recorder.steps[-1]["seconds"] * 1e3)
        bare_ms = {name: statistics.median(times) for name, times in bare_ms.items()}
        step_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        check_loop_steps(recorder.steps, pretraining_steps)

    # The loop's step period: from one full-phase step's start to the next's
    # (the step, the loader's wait, the host copy and the logging).
    starts = {r["step"]: r["start"] for r in recorder.steps[:6]}
    periods_ms = [(starts[s + 1] - starts[s]) * 1e3 for s in range(pretraining_steps + 1, 6)]
    loop_step_ms = statistics.median(periods_ms)
    kernels = sorted(((e.key, e.device_time_total / 2 / 1e3, e.count / 2)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels) if kernels else None
    emit(phase="loop_time", dtype="bf16", batch=LOOP_BATCH, frames=LOOP_FRAMES,
         loop_step_ms=loop_step_ms, loop_step_periods_ms=periods_ms,
         loop_steps_per_sec=1e3 / loop_step_ms,
         bare_train_step_ms_device_batch=bare_ms["device_batch"],
         bare_train_step_ms_host_batch=bare_ms["host_batch"],
         host_copy_ms=bare_ms["host_batch"] - bare_ms["device_batch"],
         loader_and_logging_ms=loop_step_ms - bare_ms["host_batch"],
         loop_peak_memory_gib=loop_peak_gib, train_step_peak_memory_gib=step_peak_gib,
         profiled_step_wall_ms=profiled_ms, step_device_busy_ms=busy_ms,
         device_idle_share=None if busy_ms is None else 1 - busy_ms / loop_step_ms,
         kernels_per_step=sum(k[2] for k in kernels))
    emit(phase="loop_step_breakdown", **breakdown(kernels, 25))
    emit(phase="train_loop", launches=launches)
    return launches


def per_frame_launches(frames: int) -> dict:
    """A play step's launches, ``frames`` times: K1 3 and K3 15, K2 none."""
    return {"convlstm_gates": 3 * frames, "convlstm_gates_bwd": 0,
            "fused_norm_act": 15 * frames}


def add_launches(totals: dict, launches: dict) -> None:
    for name, count in launches.items():
        totals[name] += count


def reference_key(key: str) -> str:
    """The reference checkpoint's name of a port state key (other than the
    fused gate convolution's), whose module path carries the Flax names."""
    if key == "centroids":
        return "centroid_estimator.estimated_centroids"
    parts = key.split(".")
    top, rest, leaf = parts[0], parts[1:-1], parts[-1]

    def block(inner):  # a residual block's layers
        names = {"shortcut_conv": ["downsample", "0"], "shortcut_bn": ["downsample", "2"]}
        return names.get(inner[0], inner[:1]) + inner[1:]

    def residuals(head):
        if rest[0].startswith("res"):
            return head + ["residuals", rest[0][3:]] + block(rest[1:])
        return head + rest

    if top == "state_to_hidden":
        path = ["state_to_hidden_state_layer", "0"]
    elif top == "representation_network":
        path = residuals([top])
    elif top.startswith("action_network_"):
        path = residuals(["action_network", top[len("action_network_"):]])
    elif top == "dynamics_network" and rest[0].startswith("lstm"):  # the initial states
        path = [top, "recurrent_layers_blocks", rest[0][4:], "0"]
        leaf = {"initial_hidden_state": "initial_hidden_state",
                "initial_cell_state": "initial_hidden_cell_state"}[leaf]
    elif top == "dynamics_network" and rest[0].startswith("bn"):
        path = [top, "recurrent_layers_blocks", rest[0][2:], "1"]
    elif top == "dynamics_network":
        path = ([top, "non_recurrent_blocks", {"same0": "0", "up0": "1", "same1": "2"}[rest[0]]]
                + block(rest[1:]))
    elif top == "rendering_network" and rest[0].startswith("final"):
        path = [top, "final_blocks", rest[0][len("final"):]]  # the 'conv' level dropped
    elif top == "rendering_network" and rest[0] == "up2":
        path = [top, "upsample_blocks", "2"] + rest[1:]
    elif top == "rendering_network":
        path = ([top, "upsample_blocks", rest[0][-1], "0" if rest[0].startswith("up") else "1"]
                + block(rest[1:]))
    else:
        raise KeyError(key)
    return ".".join(path + [leaf])


def reference_state_dict(model) -> dict:
    """The model's weights as the reference's state_dict, on the CPU:
    per-gate ConvLSTM convolutions in i, f, o, g order, a
    ``num_batches_tracked`` per BatchNorm, the reference's names; kernels,
    linears and initial states are already in its layouts."""
    state = {}
    for key, value in model.state_dict().items():
        value = value.detach().cpu().clone()
        if ".cell.gates." in key:
            layer, leaf = key.split(".")[1][len("lstm"):], key.rsplit(".", 1)[1]
            for gate, part in zip(REFERENCE_GATES, value.chunk(4, dim=0)):
                state[f"dynamics_network.recurrent_layers_blocks.{layer}.0.cell.{gate}.{leaf}"] = (
                    part.clone())
            continue
        state[reference_key(key)] = value
        if key.endswith("running_mean"):
            state[reference_key(key).replace("running_mean", "num_batches_tracked")] = (
                torch.tensor(0))
    return state


def write_reference_checkpoint(model, path: str) -> None:
    """Saves the model's weights as a reference ``.pth.tar``, ``{"model":
    state_dict}``, as the reference's trainer saves them."""
    torch.save({"model": reference_state_dict(model)}, path)


def test_split_videos(config: dict) -> list:
    """Phase 11's test split: TEST_VIDEOS synthetic videos of
    TEST_VIDEO_FRAMES at the config's size, seeded apart from phase 10's."""
    width, height = config["model"]["representation_network"]["target_input_size"]
    return [make_moving_square_video(TEST_VIDEO_FRAMES, height, width, square=height // 8,
                                     actions_count=config["data"]["actions_count"],
                                     seed=SEED + 100 + i, step_pixels=height // 20)
            for i in range(TEST_VIDEOS)]


def write_metric_weights(directory: str) -> None:
    """Random, seeded ``vgg19.npz`` and ``lpips_lin.npz`` in the layout that
    ``tools/convert_weights.py`` writes (flax names and HWIO kernels; one
    (C,) head per level), so that the pretrained VGG19 and LPIPS run."""
    vgg = make_metric_vgg(None, "cpu")
    params = {}
    for name, conv in vgg.named_children():
        params[name] = {"kernel": conv.weight.detach().permute(2, 3, 1, 0).numpy(),
                        "bias": conv.bias.detach().numpy()}
    save_variables_npz({"params": params}, os.path.join(directory, "vgg19.npz"))
    rng = np.random.default_rng(SEED)
    np.savez(os.path.join(directory, "lpips_lin.npz"),
             **{f"lin{i}": rng.uniform(0, 1, c).astype(np.float32)
                for i, c in enumerate(LPIPS_CHANNELS)})


def evaluation_config(root: str) -> dict:
    """BAIR's evaluation config with its outputs under ``root`` and the
    metric weights in ``root/weights``, checked."""
    config = copy.deepcopy(BAIR_EVALUATION_CONFIG)
    config["logging"]["output_root"] = os.path.join(root, "evaluation_results")
    config["tpu"] = {"pretrained_weights_dir": os.path.join(root, "weights")}
    EvaluationConfiguration(config=config).check_config(check_data_root=False)
    return config


class EvaluationRecorder:
    """Within the block, each dataset evaluator's frame-metric batches (the
    five metrics with VGG19, and LPIPS), LPIPS alone (synchronised around
    it) and the whole ``compute_metrics`` are timed."""

    def __enter__(self):
        self.frame_s, self.lpips_s, self.total_s = [], [], []
        self._saved = DatasetEvaluator._compute_frame_metrics, DatasetEvaluator.compute_metrics
        frame_metrics, compute_metrics = self._saved
        recorder = self

        def timed_lpips(lpips_fn):
            def fn(reference, generated):
                torch.cuda.synchronize()
                start = time.perf_counter()
                out = lpips_fn(reference, generated)
                torch.cuda.synchronize()
                recorder.lpips_s.append(time.perf_counter() - start)
                return out
            return fn

        def recorded_frame_metrics(evaluator, reference, generated):
            if evaluator.lpips_fn is not None and not hasattr(evaluator, "_timed"):
                evaluator.lpips_fn, evaluator._timed = timed_lpips(evaluator.lpips_fn), True
            start = time.perf_counter()
            out = frame_metrics(evaluator, reference, generated)  # ends in a readback
            recorder.frame_s.append(time.perf_counter() - start)
            return out

        def recorded_compute_metrics(evaluator):
            start = time.perf_counter()
            out = compute_metrics(evaluator)
            recorder.total_s.append(time.perf_counter() - start)
            return out

        DatasetEvaluator._compute_frame_metrics = recorded_frame_metrics
        DatasetEvaluator.compute_metrics = recorded_compute_metrics
        return self

    def __exit__(self, *exc_info):
        DatasetEvaluator._compute_frame_metrics, DatasetEvaluator.compute_metrics = self._saved


def check_evaluation_dataset(videos: list, frames: int, frame_shape: tuple) -> None:
    """The builder's videos: uint8 frames of ``frame_shape``, per frame the
    metadata ``{model, inferred_action, encoded_action}``, ``{model}`` on
    the last."""
    for video in videos:
        require(video.get_frames_count() == frames, video.get_frames_count())
        for i in range(frames):
            frame = video.get_frame_at(i)
            require(frame.dtype == np.uint8 and frame.shape == frame_shape,
                    (frame.dtype, frame.shape))
        for meta in video.metadata[:-1]:
            require(sorted(meta) == ["encoded_action", "inferred_action", "model"], meta)
            require(meta["model"] == "ours" and 0 <= meta["inferred_action"] < 7
                    and len(meta["encoded_action"]) == 2
                    and all(math.isfinite(v) for v in meta["encoded_action"]), meta)
        require(video.metadata[-1] == {"model": "ours"}, video.metadata[-1])


def check_offline_metrics(metrics: dict, frames: int) -> None:
    """Every expected key of BAIR's offline evaluation, the markers of the
    backbones that are not there, and finite numbers, but for the kurtosis
    of a movement component that does not vary within an action, which is
    undefined (NaN in both packages)."""
    for prefix in ("mse", "motion_masked_mse", "psnr", "ssim", "vgg_sim", "lpips"):
        for suffix in ["avg", "var"] + [str(i) for i in range(frames)]:
            require(f"{prefix}/{suffix}" in metrics, f"no {prefix}/{suffix}")
    markers = ["fid_unavailable", "fvd_unavailable", "detection_unavailable"]
    if importlib.util.find_spec("sklearn") is None:
        markers.append("action_classification_unavailable")
    else:
        require("action_classification/linear/accuracy" in metrics, "no SVM accuracy")
    for marker in markers:
        require(marker in metrics, f"no {marker}")
    require("vgg_sim_note" not in metrics and "lpips_unavailable" not in metrics,
            "the converted VGG19 and LPIPS weights were not used")
    require("action_variance/avg_variance/global" in metrics, "no action-space statistics")
    for key, value in metrics.items():
        if isinstance(value, str):
            continue
        values = np.asarray(value, np.float64)
        if "/kurtosis/" in key:
            variance = np.asarray(metrics[key.replace("/kurtosis/", "/variance_vector/")])
            values = values[variance > 0]
        require(np.isfinite(values).all(), f"{key}: {value}")


def after_training(root: str) -> dict:
    """Phase 11, after training, on phase 10's run: the play CLI, the
    interpolation, a reference checkpoint's import, the evaluation-dataset
    builder and the offline evaluation, at BAIR's full width in bf16, then
    the builder and the frame metrics in f32 on the card against the CPU.
    Returns the launch counts of its first five steps."""
    config = loop_config(root)
    datasets = loop_datasets(config)
    validation = datasets["validation"]
    actions_count = config["data"]["actions_count"]
    width, height = config["model"]["representation_network"]["target_input_size"]
    frame_shape = (height, width, 3)
    totals = dict.fromkeys(KERNELS, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    play_base_gib = torch.cuda.memory_allocated() / 2 ** 30

    # 1. The play CLI: the run's latest checkpoint, a start frame of a
    # validation sequence, the scripted rollout with its single readback.
    session, observation, logger = load_play_session(config, device="cuda", dataset=validation)
    require(not session.model.training, "the play model is in training mode")
    reset_launches()
    with counted_syncs() as syncs:
        frames, actions = scripted_rollout(session, actions_count, AFTER_ROLLOUT_FRAMES, logger)
    launches = read_launches()
    require(launches == per_frame_launches(AFTER_ROLLOUT_FRAMES),
            f"the scripted rollout launched {launches}")
    require(len(syncs) == 1, f"the scripted rollout synchronised {len(syncs)} times: {syncs}")
    require(frames.dtype == np.uint8 and frames.shape == (AFTER_ROLLOUT_FRAMES,) + frame_shape
            and frames.std() > 0, (frames.dtype, frames.shape))
    add_launches(totals, launches)
    rollout_s = []
    reset_launches()
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        session.rollout(np.asarray(actions))
        rollout_s.append(time.perf_counter() - start)
    add_launches(totals, read_launches())
    emit(phase="after_play_cli", frames=AFTER_ROLLOUT_FRAMES, launches=launches,
         rollout_syncs=len(syncs), frames_per_s=AFTER_ROLLOUT_FRAMES / statistics.median(rollout_s),
         frames_per_s_all=[AFTER_ROLLOUT_FRAMES / s for s in rollout_s], card=nvidia_smi())

    # 2. Interpolation: 11 factors x 4 frames, in memory (on disk where
    # Pillow is installed).
    reset_launches()
    sequences = interpolate(config, 0, 3, frames_per_sequence=INTERPOLATION_FRAMES,
                            device="cuda", dataset=validation,
                            save=importlib.util.find_spec("PIL") is not None)
    launches = read_launches()
    steps = INTERPOLATION_FACTORS * INTERPOLATION_FRAMES
    require(launches == per_frame_launches(steps), f"{steps} interpolation steps: {launches}")
    require(len(sequences) == INTERPOLATION_FACTORS, sorted(sequences))
    for sequence in sequences.values():
        require(len(sequence) == INTERPOLATION_FRAMES, len(sequence))
        for frame in sequence:
            check_frame(frame, frame_shape)
    add_launches(totals, launches)
    emit(phase="after_interpolate", sequences=sorted(sequences), launches=launches)

    # 3. A reference .pth.tar of the played weights, imported into a model
    # seeded otherwise: every tensor bit for bit, then one play frame.
    source = session.model
    path = os.path.join(root, "reference.pth.tar")
    write_reference_checkpoint(source, path)
    importer = Trainer(config, make_model(config, "cuda", SEED + 1), smooth_mi=True, seed=SEED)
    importer.init_state()
    importer.load_reference_weights(path)
    want, got = source.state_dict(), importer.model.state_dict()
    require(list(got) == list(want), "the imported model's tensors differ")
    for key, value in want.items():
        require(torch.equal(got[key], value), f"{key} was not imported bit for bit")
    require(importer.state.step == 0 and not importer.state.optimizer.state_dict()["state"],
            "the import touched the optimizer")
    reset_launches()
    frame = PlaySession(importer.model.eval()).start(observation).generate_next(1)
    launches = read_launches()
    require(launches == per_frame_launches(1), f"the imported model's step launched {launches}")
    check_frame(frame, frame_shape)
    add_launches(totals, launches)
    emit(phase="after_reference_import", tensors=len(want), bit_exact=True, launches=launches,
         play_peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         allocated_before_gib=play_base_gib)
    del importer, session

    # 4. The evaluation-dataset builder over 2 batches of 8 x 30 test
    # sequences, on a model that a trainer left in training mode; then a
    # train step on the same model.
    test_videos = test_split_videos(config)
    test = VideoDataset.from_videos(test_videos, config["evaluation"]["batching"],
                                    get_final_transforms(config)["test"])
    require(len(test) == BUILDER_BATCHES * LOOP_BATCH, len(test))
    builder = make_evaluation_dataset_builder(config, device="cuda", dataset=test)
    trainer = Trainer(config, builder.model, smooth_mi=True, seed=SEED)
    trainer.init_state()
    forwards, forward = [], builder._forward

    def recorded_forward(*args):
        before = read_launches()
        out = forward(*args)
        forwards.append(launches_since(before))
        return out

    builder._forward = recorded_forward
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    builder_base_gib = torch.cuda.memory_allocated() / 2 ** 30
    start = time.perf_counter()
    videos = builder.build_videos()  # each batch read back
    build_s = time.perf_counter() - start
    builder_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    add_launches(totals, read_launches())
    want = {"convlstm_gates": EVAL_GATE_LAUNCHES, "convlstm_gates_bwd": 0,
            "fused_norm_act": len(EVAL_NORM_SHAPES)}
    require(len(forwards) == BUILDER_BATCHES and all(f == want for f in forwards),
            f"builder batches launched {forwards}")
    require(builder.model.training, "the builder left the model in evaluation mode")
    require(len(videos) == BUILDER_BATCHES * LOOP_BATCH, len(videos))
    check_evaluation_dataset(videos, EVAL_FRAMES, frame_shape)
    train_set = datasets["train"]
    train_set.set_observations_count(LOOP_FRAMES)
    batch = collate([train_set[i] for i in range(LOOP_BATCH)])
    reset_launches()
    metrics = trainer.train_step(batch)
    launches = read_launches()
    step_want = {"convlstm_gates": 3 * LOOP_DYNAMICS_STEPS,
                 "convlstm_gates_bwd": 3 * LOOP_DYNAMICS_STEPS, "fused_norm_act": 0}
    require(launches == step_want and np.isfinite(metrics["loss"]),
            f"the train step after the builder launched {launches}, loss {metrics['loss']}")
    add_launches(totals, launches)
    emit(phase="after_builder", batches=BUILDER_BATCHES, batch=LOOP_BATCH, frames=EVAL_FRAMES,
         launches_per_batch=forwards[0], seconds=build_s,
         seconds_per_batch=build_s / BUILDER_BATCHES, model_mode_restored=True,
         train_step_after=launches, peak_memory_gib=builder_peak_gib,
         allocated_before_gib=builder_base_gib)
    del trainer

    # 5. The offline evaluation: BAIR's evaluator at batch 1 x 30, the test
    # split against the builder's videos, in memory, with converted-layout
    # VGG19 and LPIPS weights.
    eval_config = evaluation_config(root)
    os.makedirs(eval_config["tpu"]["pretrained_weights_dir"])
    write_metric_weights(eval_config["tpu"]["pretrained_weights_dir"])
    reference_transform, generated_transform = get_evaluation_transforms(eval_config)
    batching = eval_config["evaluation"]["batching"]
    pair = (VideoDataset.from_videos(test_videos, batching, reference_transform),
            VideoDataset.from_videos(videos, batching, generated_transform))
    require(len(pair[0]) == len(pair[1]) == len(videos), (len(pair[0]), len(pair[1])))
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    evaluation_base_gib = torch.cuda.memory_allocated() / 2 ** 30
    with EvaluationRecorder() as timing:
        metrics = evaluate_dataset(eval_config, device="cuda", datasets=pair)
    add_launches(totals, read_launches())
    check_offline_metrics(metrics, EVAL_FRAMES)
    require(os.path.isfile(os.path.join(eval_config["logging"]["output_directory"], "data.yml")),
            "no data.yml")
    batches = len(timing.frame_s)
    frame_s, lpips_s = sum(timing.frame_s), sum(timing.lpips_s)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    emit(phase="after_evaluation", batches=batches, keys=len(metrics),
         seconds=timing.total_s[0], seconds_per_batch=timing.total_s[0] / batches,
         frame_metrics_and_vgg_s_per_batch=(frame_s - lpips_s) / batches,
         lpips_s_per_batch=lpips_s / batches,
         host_loader_detection_actions_s_per_batch=(timing.total_s[0] - frame_s) / batches,
         psnr_avg=metrics["psnr/avg"], ssim_avg=metrics["ssim/avg"],
         lpips_avg=metrics["lpips/avg"], vgg_sim_avg=metrics["vgg_sim/avg"],
         markers=sorted(k for k in metrics if k.endswith("_unavailable")),
         peak_memory_gib=peak_gib, allocated_before_gib=evaluation_base_gib,
         card=nvidia_smi())

    # 6. f32 with TF32 off, the card against the plain path on the CPU: one
    # builder batch of 2 x 8 frames, and one evaluation batch's metrics.
    after_training_parity(config, eval_config, source.state_dict(), test_videos, pair)
    emit(phase="after_training", launches=totals)
    return totals


def after_training_parity(config: dict, eval_config: dict, state: dict, test_videos: list,
                          pair: tuple) -> None:
    """Phase 11, step 6: f32 with TF32 off, the trained weights through the
    kernels on the card and the plain versions on the CPU: one builder
    batch's reconstructions within 1e-3 (the CPU taking the card's
    inferred actions, which must agree with its own up to ties), and the
    frame metrics of the first evaluation batch (1 x 30 frames, the
    converted-layout VGG19 and LPIPS) within rtol 1e-4."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    parity_config = copy.deepcopy(config)
    parity_config["tpu"]["compute_dtype"] = "float32"
    parity_config["evaluation"]["batching"] = dict(
        config["evaluation"]["batching"], batch_size=PARITY_BATCH,
        observations_count=PARITY_FRAMES)
    dataset = VideoDataset.from_videos(test_videos[:1], parity_config["evaluation"]["batching"],
                                       get_final_transforms(parity_config)["test"])
    # The one-hot sampler's argmax may break a near-tie of the action
    # logits differently on the two devices, and a different action renders
    # a different frame: the CPU follows the card's actions, and where its
    # own argmax differs, the two log-probabilities must tie within 1e-4.
    results, log_probs = {}, {}
    for device in ("cuda", "cpu"):
        model = make_model(parity_config, device)
        model.load_state_dict(state)
        builder = EvaluationDatasetBuilder(parity_config, model, dataset, Logger())

        def sampler(flat_log_probs, ground_truth, device=device):
            log_probs[device] = flat_log_probs.detach().float().cpu()
            index = (flat_log_probs.argmax(-1) if device == "cuda"
                     else results["cuda"][1].reshape(-1).to(flat_log_probs.device))
            return torch.nn.functional.one_hot(index, flat_log_probs.shape[-1]).to(
                flat_log_probs.dtype)

        builder._forward = functools.partial(
            evaluation_forward, model, ground_truth_observations=(
                builder.ground_truth_observations_init),
            gumbel_temperature=builder.temperature, action_sampler=sampler,
            variation_sampler=zero_action_variation_sampler)
        batch = next(iter(builder.dataloader))
        reset_launches()
        # The action network's sampled directions, from which the inferred
        # actions come, take the same noise on both: a CPU generator each,
        # seeded alike, as in phase 8.
        frames, out = builder.reconstruct(batch, torch.Generator().manual_seed(SEED))
        results[device] = frames.cpu(), out.selected_actions.cpu()
        if device == "cuda":
            torch.cuda.synchronize()
            launches = read_launches()
    want = {"convlstm_gates": 3 * (PARITY_FRAMES - 1), "convlstm_gates_bwd": 0,
            "fused_norm_act": len(PARITY_NORM_SHAPES)}
    require(launches == want, f"the f32 builder batch launched {launches}")
    (got, card_actions), (want_frames, _) = results["cuda"], results["cpu"]
    width, height = config["model"]["representation_network"]["target_input_size"]
    require(got.shape == (PARITY_BATCH, PARITY_FRAMES, 3, height, width), got.shape)
    cpu_log_probs, card = log_probs["cpu"], card_actions.reshape(-1)
    cpu_choice = cpu_log_probs.argmax(-1)
    positions = torch.arange(len(card))
    tie_gap = (cpu_log_probs[positions, cpu_choice] - cpu_log_probs[positions, card]).max().item()
    log_prob_err = (log_probs["cuda"] - cpu_log_probs).abs().max().item()
    builder_err = (got - want_frames).abs().max().item()
    emit(phase="after_builder_parity", dtype="f32", tf32=False, batch=PARITY_BATCH,
         frames=PARITY_FRAMES, launches=launches, max_abs_err=builder_err, tolerance=1e-3,
         action_log_prob_max_abs_err=log_prob_err,
         inferred_actions_differing=int((cpu_choice != card).sum()),
         inferred_actions=len(card), differing_log_prob_gap=tie_gap)
    require(tie_gap <= 1e-4, f"the CPU's inferred actions differ from the card's by a "
                             f"log-probability gap of {tie_gap}, not a tie")
    require(builder_err <= 1e-3, f"the f32 builder batch differs from the CPU by {builder_err}")

    tree = load_variables_npz(os.path.join(eval_config["tpu"]["pretrained_weights_dir"],
                                           "vgg19.npz"))
    heads = load_lpips_linear_weights(os.path.join(eval_config["tpu"]["pretrained_weights_dir"],
                                                   "lpips_lin.npz"))
    reference, generated = collate([pair[0][0]]), collate([pair[1][0]])  # batch 1
    metrics = {}
    for device in ("cuda", "cpu"):
        evaluator = DatasetEvaluatorBair(
            eval_config, Logger(), *pair, vgg_variables=tree,
            lpips_fn=make_lpips_fn(make_metric_vgg(tree, device), heads), device=device)
        metrics[device] = evaluator._compute_frame_metrics(reference.observations,
                                                           generated.observations)
    errors = {}
    for key, value in metrics["cpu"].items():
        errors[key] = float(np.max(np.abs(metrics["cuda"][key] - value)
                                   / np.maximum(np.abs(value), 1e-12)))
        require(errors[key] <= 1e-4, f"f32 {key} on the card differs from the CPU: {errors[key]}")
    emit(phase="after_metric_parity", dtype="f32", tf32=False, frames=EVAL_FRAMES,
         max_rel_err=errors, tolerance=1e-4)


def kernel_group(name: str) -> str:
    return next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), "other")


def breakdown(kernels, top: int) -> dict:
    """The profiled step's device time by kernel group, its ``top``
    kernels, and each of the port's kernels on its own."""
    groups = {}
    for name, ms, calls in kernels:
        total = groups.setdefault(kernel_group(name), dict(ms=0.0, calls=0.0))
        total["ms"] += ms
        total["calls"] += calls

    def rows(ks):
        return [dict(kernel=k[0][:90], ms=k[1], calls=k[2]) for k in ks]

    return dict(groups=groups, top=rows(kernels[:top]),
                port=rows(k for k in kernels if kernel_group(k[0]) == "port_kernels"))


KERNEL_NAME = re.compile(r"\d+([a-z_]+?_kernel)I(13__nv_bfloat16|f)(?:Li(\d+)E)?")
PTXAS_KERNEL = re.compile(r"(?:Compiling entry function '|Function properties for )([\w$]+)")
PTXAS_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
PTXAS_REGISTERS = re.compile(r"Used (\d+) registers")
SASS_KERNEL = re.compile(r"Function : (\S+)")
SASS_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?!NOP\b)\S")


def kernel_label(mangled: str) -> str:
    """'gates_fwd_kernel<bf16,8>' for a kernel's mangled name."""
    m = KERNEL_NAME.search(mangled)
    if m is None:
        return mangled
    args = ["bf16" if m.group(2) == "13__nv_bfloat16" else "f32"]
    return f"{m.group(1)}<{','.join(args + [m.group(3)] * bool(m.group(3)))}>"


def kernel_report(logs: dict) -> dict:
    """Each kernel's registers and spills from nvcc's ``-Xptxas=-v`` output
    and, where the toolkit has ``cuobjdump``, its static SASS instruction
    count (NOPs aside)."""
    report, current = {}, {}
    for line in "\n".join(logs.values()).splitlines():
        if m := PTXAS_KERNEL.search(line):
            current = report.setdefault(kernel_label(m.group(1)), {})
        elif m := PTXAS_SPILLS.search(line):
            current.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif m := PTXAS_REGISTERS.search(line):
            current["registers"] = int(m.group(1))
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    if not cuobjdump.is_file():
        return report
    for name in build.sources():
        sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        for line in sass.splitlines():
            if m := SASS_KERNEL.search(line):
                current = report.setdefault(kernel_label(m.group(1)), {})
                current["sass_instructions"] = 0
            elif SASS_INSTRUCTION.search(line):
                current["sass_instructions"] += 1
    return report


def check_norm_call(model, gen) -> None:
    """Phase 4b: one of the model's frozen BatchNorm + LeakyReLU calls,
    profiled, runs exactly one kernel, K3, with no fold or cast around it."""
    from torch.profiler import ProfilerActivity, profile

    norm = next(m for m in model.modules()
                if isinstance(m, BatchNorm) and m.activation == "leaky_relu")
    x = on_card((1, norm.weight.shape[0], 64, 64), torch.bfloat16, gen)
    with torch.no_grad():
        norm(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            norm(x)
            torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    require(len(kernels) == 1 and kernels[0][1] == 1
            and "batch_norm_leaky_relu_kernel" in kernels[0][0],
            f"a frozen BatchNorm + LeakyReLU call ran {kernels}")
    emit(phase="norm_call", channels=norm.weight.shape[0], kernels=kernels)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; it needs an "
                 "NVIDIA GPU")
    card = nvidia_smi()
    emit(phase="device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    logs = build.build()
    emit(phase="build", seconds=time.perf_counter() - t0, sources=build.sources(),
         kernels=kernel_report(logs))

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errors = check_kernels(gen)
    errors["convlstm_gates_bwd"] = check_gate_backward(gen)

    rng = np.random.default_rng(SEED)
    obs = rng.uniform(-1, 1, (256, 256, 3)).astype(np.float32)
    actions = rng.integers(0, 7, ROLLOUT_FRAMES)
    model = flagship_model("cuda", torch.bfloat16, SEED)
    play_launches = play_route(model, obs, actions)
    check_norm_call(model, gen)
    route_parity(obs, actions)

    sums = time_kernels(gen)
    time_loop_kernels(gen)
    time_route(model, obs, actions)
    del model

    trainer = flagship_trainer()
    batch = device_batch(make_synthetic_batch(
        batch_size=TRAIN_BATCH, observations_count=TRAIN_FRAMES, height=256, width=256,
        seed=SEED))
    train_launches = train_route(trainer, batch)
    train_parity()
    sums["convlstm_gates_bwd"] = time_gate_kernels_in_training(gen)
    time_train(trainer, batch)
    del trainer, batch

    with tempfile.TemporaryDirectory() as root:
        loop_launches = train_loop(root)
        after_launches = after_training(root)

    kernels = [dict(name=name, route="cuda",
                    source=f"playablevideogeneration_tpu_torch/ops/cuda/csrc/{source}.cu",
                    replaces=replaces,
                    launches=(play_launches[name] + train_launches[name] + loop_launches[name]
                              + after_launches[name]),
                    max_abs_err=errors[name], ms=sums[name]["ms"],
                    cold_ms=sums[name]["cold_ms"],
                    plain_ms=sums[name]["plain_ms"], bound_ms=sums[name]["bound_ms"],
                    bound_by=sums[name]["bound_by"], library_ms=None)
               for name, (source, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
