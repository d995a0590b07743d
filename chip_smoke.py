"""Drives the PyTorch/CUDA port's play and training routes, its training
loop, the entry points after training, the distribution metrics, the
convergence soak, the Faster R-CNN detector (its NMS in K4, two
hand-written kernels), data- and tensor-parallel
training, the tools (the step profiler, the input-pipeline bench and the
CLI soak), the graphed inference routes and the graphed training step and
evaluation batch against eager ones, on one NVIDIA Hopper GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on a failed check:

1. device: a CUDA device must be visible; prints nvidia-smi's name and
   power limit;
2. build: compiles every kernel under
   ``playablevideogeneration_tpu_torch/ops/cuda/csrc`` with nvcc for sm_90a;
   Reports each kernel's registers and spills (``-Xptxas=-v``) and, where
   the toolkit has ``cuobjdump``, its static SASS instruction count (per
   element for the gate kernels);
3. kernels: holds each kernel against its plain PyTorch version on the card
   at every shape the flagship's play and training steps give it (batch 1
   and 16), the training loop's gate shapes at batch 8, every shape an
   evaluation or builder batch gives K3 (8 x 30 frames: ``EVAL_NORM_SHAPES``)
   and phase 11's f32 builder batch of 2 x 8 frames gives K1 and K3, phase
   15's ranks' 4 rows give K1 and K2, plus a
   ragged case (3x65x25x40), a C*H*W that is no multiple of a vector
   (3x5x7x9) and inputs whose storage starts one element into its buffer,
   in f32 and bf16, and K2 at the training and loop shapes, the ragged and
   unvectored cases and a view one element into its buffer: each must
   equal its plain version bit for bit, and each case must take the path
   it should (packs of 4 elements for K1 and K2 and of 16 bytes for K3,
   or one element per thread where the sizes or the alignment forbid
   them); K4 (the NMS of score-sorted boxes: the packed IoU > threshold
   rows, then the sweep) bit for bit at every set shape of a 16-frame
   detector call (64 and 16 sets of 1000 candidates, 16 of 504), at 1,
   33, 999 and 1024 candidates, at IoU thresholds 0.5 and 0.7, with every
   pair or no pair overlapping and on pairs whose f32 IoU sits on the f32
   threshold or a few ulps either side, and its sweep kernel alone on the
   plain version's rows; and the
   gate update's autograd function (K1 forward, K2 backward) against
   autograd through the plain gate math (1e-5);
4. play route: the bf16 flagship (configs/01_bair.yaml, seeded random
   weights and BatchNorm statistics) through ``PlaySession``, whose steps
   and rollouts replay captured CUDA graphs: start, three
   ``generate_next``, ``generate_next_u8``, ``generate_next_interpolation``
   and a 64-action ``rollout``; every step must launch the gate kernel 3
   times and the norm kernel 15 times (a replay counts what its capture
   launched), frames must be finite and in [-1, 1], and the rollout, its
   capture included, must synchronise with the host once; one of
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
   route graphed (``PlaySession``) and eager (``model.play_step`` op by
   op): the step's latency, the interactive uint8 step's, the rollout's
   frame rate, and the step's kernel count, device-time breakdown and idle
   share (a graph's kernels reach the profiler as kernels, without the
   operators that launched them at capture);
7. train route: the bf16 flagship trainer (batch 16, 12 frames, smooth MI,
   per-step activation checkpointing, seeded weights and batch), each step
   a replay of a captured CUDA graph (``graphs.TrainProgram``), takes one
   pretraining and three full-phase steps; each must give a finite loss and
   finite gradient norms and launch K1 66 times (33 forward, 33 in the
   checkpoint recompute), K2 33 times and K3 never, one capture per
   (phase, ground-truth frames); the parameters must change;
8. train parity: one full-phase step in f32 with TF32 off, at full width on
   a short batch (2 x 4 frames, 2 ground-truth frames), through the kernels
   on the card and the plain versions on the CPU, with the same weights and
   the same noise (drawn from one CPU generator, so the card's step runs op
   by op: a graph cannot replay a host generator): the loss and every term
   within rtol 1e-3, the per-subnetwork gradient norms within rtol 1e-2;
9. train timings: K1's and K2's device time per launch at the training
   shapes, warm and cold, beside their bounds and plain versions' times,
   the median bf16 train step, ``train_frames_per_sec`` (B*T per step),
   peak device memory, and the device's busy and idle share and
   kernel-time breakdown over two profiled steps (the port's kernels listed
   one by one), both ways: phase 7's graphed trainer and one op by op
   (``graphs.Eager``) from the same seed;
10. train loop: BAIR's config (``BAIR_CONFIG``, pinned to
   configs/01_bair.yaml by a CPU test, with ``LOOP_OVERRIDES``) through
   ``cli.train.train`` on in-memory synthetic videos at 256x256 (the card's
   machine has neither Pillow nor PyYAML): batch 8 at 7 frames, 2
   pretraining and 4 full-phase steps, ``latest`` and ``checkpoint_6``, and
   the evaluation's three passes (Gumbel, one-hot, ground truth through the
   Hungarian mapping) at 8 x 30 frames, with a random VGG19 written as
   converted weights (``vgg19.npz``, seeded apart from the fallbacks) into
   ``tpu.pretrained_weights_dir``: the run's trainer must load it bit for
   bit, computing in bf16, and a run's two evaluators must share it in
   f32.  The train steps and the evaluation batches are graph replays.
   Every train step must give finite values, the
   schedules' values at its step, and launch K1 and K2 3(T-1)
   times each and K3 never (steps after an evaluation included); every
   evaluation batch K1 87 and K3 446 times and K2 never; one-hot samples
   no entropy and the ground-truth pass accuracy 1; a fresh run's
   ``load_checkpoint`` must restore every tensor and step exactly, and a
   second ``train`` must resume and take 2 steps.  Prints the loop's step
   period beside bare ``train_step``s (batch on the card, batch on the
   host), evaluation seconds, checkpoint size and save/load seconds, peak
   memory, and the device's idle share over two profiled loop steps.
11. after training, on phase 10's run and its ``latest`` checkpoint, at
   BAIR's full width in bf16, every play step and builder forward a graph
   replay: the play CLI (``cli.play.load_play_session`` and its scripted
   64-frame rollout: 3 K1 + 15 K3 launches per frame, no K2, one
   synchronisation, uint8 frames; frames/s), ``cli.interpolate``
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
   absent backbones, finite values; seconds per batch split into the
   frame metrics (a graph replay) and the host's share; peak memory), one
   batch's frame metrics graphed against op by op (``graphs.Eager``): bit
   for bit, two copies in and one out, both ways timed and profiled, LPIPS
   alone op by op; and last
   f32 with TF32 off against the CPU's plain path: one builder batch of 2 x
   8 frames within 1e-3 (the CPU following the card's inferred actions,
   which must match its own but for ties within 1e-4 of log-probability),
   the frame metrics of one evaluation batch within rtol 1e-4.
12. distribution metrics, on phase 11's builder videos and test split
   (16 + 16 sequences of 30 frames): random ``fid_inception.npz`` (with
   its 1008-way ``fc`` head) and ``i3d.npz`` written in the converter's
   layout (seeded apart from every other seed here) beside phase 11's
   weights; ``cli.evaluate_dataset`` with BAIR's evaluation config and the
   Inception Score on, at the full input sizes (299 and 224) and the
   port's defaults (cuDNN's TF32 on): ``fid``, ``fvd``,
   ``inception_score`` and ``inception_score_std`` finite, none of their
   markers, no launch of the port's kernels; the extractor, the
   classifier and the embedder hold the files' weights bit for bit;
   ``cli.fid`` on the two datasets' statistics (written with the card's
   extractor) prints the evaluator's FID within rtol 1e-9, and
   ``--weights`` resolves the file; FID and FVD again with TF32 off (each
   backbone a graph per input shape and TF32 setting); the extractor, the
   classifier (30 frames) and the embedder (16 videos) graphed against
   op by op with TF32 off, bit for bit, one copy in and one out, timed and
   profiled both ways; in f32 with TF32 off, the card against the CPU: Inception's features of 4
   frames and I3D's embeddings of 2 videos within atol 1e-4 * max(scale,
   0.1) and rtol 1e-4, the class probabilities within 1e-5.  Prints the
   Inception's ms per 30-frame batch, the I3D's per 16-video call, the
   host's ``sqrtm`` seconds for the 2048 and 400-wide covariances, the
   evaluation's seconds and peak memory.
13. convergence soak: ``tools.convergence_soak`` in bf16 on
   docs/CONVERGENCE.md's breakout_fixed_row setting (3 actions, 1-D
   direction latent, the square's row pinned; 48x48 frames, hidden 32,
   batch 16, 6 frames, in-memory videos) cut to 20 pretraining and 80
   full-phase steps with an evaluation every 50 and no example images,
   run twice in one root (``--stop-at 50``, then resumed to 100), its
   steps and evaluation batches graph replays: every
   logged loss finite, ``eval_curve.jsonl`` and ``summary.json`` written,
   the second run starting at step 51; K1 and K2 15 times per train step
   and K3 never, K1 15 and K3 86 times per evaluation batch of 8 x 6
   frames; K1, K2 and K3 bit for bit against their plain versions at every
   (shape, dtype) the soak gave them.  Prints the ms per train step
   (median and range) and per evaluation; the accuracy target is not
   required.
14. detector: a random ``frcnn.npz`` in the converter's layout (seeded
   apart from every other seed here, the person bias raised) resolved by
   ``make_detector`` for ``evaluation.detector: frcnn``: the weights the
   file's bit for bit; 16 tennis-shaped 96x256 frames at the default
   800/1333 transform (500x1333, padded to 512x1344) give static, finite
   outputs and person boxes above 0.8, the forward one replayed graph
   with 6 K4 launches (2 per set shape), one copy in and three out; the
   same call op by op (``graphs.Eager``) bit for bit; ms per frame both
   ways, whole and split into the backbone and FPN and the box stages (as
   graphs on static frames and levels), kernels and copies per frame,
   peak memory; K4 bit for bit and timed on the call's own sorted boxes,
   its two kernels apart; the NMS path per call (the score order, K4, and
   the PyTorch passes that its mask kernel replaced) and its peak memory;
   person boxes with TF32 on and off (a graph each, each equal to op by
   op); then f32 with TF32 off, the
   card against the CPU at a 32/86 transform: the FPN levels within atol
   1e-4 * max(scale, 0.1) and rtol 1e-4, the detections within 1e-4
   (scores) and 1e-2 px (boxes) in every frame with no person score within
   1e-4 of 0.05 or 0.8 and no top-100 cut within 1e-4 (flips across those
   counted), and the test suite's exact rig (every score tied) bit for bit.
15. data-parallel training: BAIR's loop config (256x256, hidden 128, bf16,
   global batch 8 at 7 frames) cut to one pretraining and three
   full-phase steps and an evaluation after the fourth (one batch per
   pass), through ``cli.train.train`` in processes that this script starts
   with torchrun's environment (``chip_smoke.py --data-parallel-rank
   SPEC``), every step deterministic (``torch.use_deterministic_algorithms``).
   (a) one NCCL rank beside the one-process trainer: every step's state
   (parameters, buffers, Adam's moments, centroids, MI matrix) and the
   loss bit for bit; (b) two gloo ranks sharing the card, 4 rows each:
   bit for bit with each other after every step, within
   ``__graft_entry__.dryrun_multichip``'s tolerances of (a) after steps 1
   and 2 (the loss within 1e-3 relative at step 1; parameters rtol 2e-3
   and atol 4 lr; BatchNorm statistics, centroids and MI matrix atol lr),
   K1 and K2 18 times per rank per step and K3 never, rank 0 alone
   evaluating; (c) (b)'s checkpoint resumed on one NCCL rank and (a)'s on
   two gloo ranks: the state bit for bit and the next step's loss finite.
   Prints ms per step per rank (median and range of steps 2-4), one
   step's collectives replayed alone as the gloo all-reduce's share of the
   step, and peak memory per rank.  NCCL across several cards is not
   exercised: the machine has one.
16. tensor-parallel training: phase 15's run with ``tpu.model_parallel``
   2 at the default ``tp_min_channels`` 256, on two gloo ranks sharing the
   card as a 1 x 2 mesh (both ranks on all 8 rows; the three ConvLSTM gate
   convolutions and the dynamics network's 256-wide convolution hold half
   their output channels per rank), every step deterministic: the ranks'
   states (the sharded tensors gathered) bit for bit with each other after
   every step and within the dryrun's tolerances of phase 15's
   one-process trainer after step 1 (the loss within 1e-3 relative), K1
   and K2 18 times per rank per step and K3 never, rank 0 alone evaluating
   on a full-width copy; phase 15's NCCL checkpoint resumed on the mesh
   bit for bit, its next full-phase step finite and within the dryrun's
   tolerances of phase 15's one-process step from the same checkpoint.
   Prints the sharded layers and the parameter bytes per rank, ms per step
   per rank (median and range of steps 2-4), one step's collectives
   replayed alone and their share of the step, and peak memory per rank.
17. tools: ``tools.profile_step`` at its defaults (the bf16 flagship
   trainer at batch 8, 12 frames, op by op: its scopes are module hooks,
   which a replay does not fire) but one profiled step after a warm one:
   K1 66 and K2 33 per profiled step in the trace, the by-group and by-scope
   tables within 1 % of the profiler's own CUDA time, the unattributed
   share, the trace's bytes and parse seconds; ``tools.bench_input_pipeline``
   as its own process at BAIR's loader shape (256x256, batch 8, 7 frames,
   21 timed batches per worker mode), frames/s beside phase 10's loop step
   period; ``tools.gpu_soak``: train, resume, play, build and evaluate, each
   a ``python -m`` process on the card from a YAML file on disk, every
   backbone on random weight files found through
   ``PVG_PRETRAINED_WEIGHTS``, every exit code 0 and the metrics validated;
   the phase's seconds.
18. graphed routes: BAIR's model config (the bf16 flagship at full width)
   with seeded weights.  The graphed ``PlaySession`` against ``EagerPlay``
   (``model.play_step`` op by op from the same state), noise off and on:
   3 ``generate_next``, a ``generate_next_u8``, a
   ``generate_next_interpolation`` and a 64-frame rollout bit for bit, 3
   K1 and 15 K3 per step under replay, one synchronisation per rollout, a
   ``block=False`` frame unchanged by two later steps, and weights loaded
   in place mid-session seen by the next step (one more capture).  The
   builder over 2 batches of 8 x 30 and a ragged batch of 4, graphed
   (twice: with its captures, then replays only) against eager: frames and
   metadata (``inferred_action``, ``encoded_action``) bit for bit, 87 K1 +
   446 K3 per batch, one program per batch shape; seconds per batch both
   ways, the device's busy time per batch, peak memory with the graph
   pools; beside phase 6's play times both ways.
19. graphed training: the flagship trainer of phase 7 graphed and op by op
   (``graphs.Eager``), each from the same seeded state: one pretraining and
   two full-phase steps (the Gumbel temperature new at each; the third
   replays the second's graph) under ``torch.use_deterministic_algorithms``
   with phase 15's cuBLAS setting, the metrics and the whole state
   (parameters, buffers, Adam's moments, MI matrix, schedule) bit for bit
   after every step, K1 66 and K2 33 per step both ways; an evaluation
   batch (BAIR's config, 8 x 30) and a ``PlaySession`` step captured on the
   graphed trainer's model before its steps and run after them, each bit
   for bit with a fresh model loaded from ``trainer.state.state_dict()``
   and each captured again; then both ways past a capture step, the median
   of 5 steps, frames/s, kernels per step, device busy time, idle share and
   peak memory (with the capture's and the deterministic steps'), beside
   phase 9's; one 8 x 30 evaluation batch through ``Evaluator.evaluate``
   graphed and op by op: the metrics bit for bit, 87 K1 + 446 K3 per batch,
   seconds per batch (the first graphed one with its capture), device busy
   time and idle share.

It prints JSON lines as it goes, then the kernels' summary line (``ms``,
``cold_ms``, ``plain_ms`` and ``bound_ms`` there are per step of the
kernel's route: the sum over a bf16 play step's launches for K1 and K3,
over a bf16 training step's 33 K2 launches for K2, over a 16-frame
detector call's 6 launches for K4; ``launches`` counts phase 4's, 7's,
10's, 11's, 13's, 15's, 16's, 17's, 18's and 19's runs in this process
for K1-K3, without the f32 parity checks and the soak's stage processes,
and phase 14's main path for K4), the card's nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import hashlib
import importlib.util
import io
import itertools
import json
import math
import os
import re
import shutil
import socket
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
from playablevideogeneration_tpu_torch.cli import fid as fid_cli
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
from playablevideogeneration_tpu_torch.evaluation.evaluator import (
    Evaluator,
    eval_mode,
    evaluation_forward,
)
from playablevideogeneration_tpu_torch.evaluation.metrics import frcnn
from playablevideogeneration_tpu_torch.evaluation.metrics.detection import make_detector
from playablevideogeneration_tpu_torch.evaluation.metrics.frcnn import random_frcnn_variables
from playablevideogeneration_tpu_torch.evaluation.metrics.fid import (
    compute_statistics_from_frames,
)
from playablevideogeneration_tpu_torch.evaluation.metrics.i3d import (
    make_fvd_embedder,
    make_i3d,
    random_i3d_variables,
)
from playablevideogeneration_tpu_torch.evaluation.metrics.inception import (
    make_class_probability_fn,
    make_fid_extractor,
    make_inception,
    random_inception_variables,
)
from playablevideogeneration_tpu_torch.evaluation.metrics.lpips import (
    load_lpips_linear_weights,
    make_lpips_fn,
)
from playablevideogeneration_tpu_torch.inference import graphs
from playablevideogeneration_tpu_torch.inference.play_session import PlaySession
from playablevideogeneration_tpu_torch.models.caddy import flagship_model, make_model
from playablevideogeneration_tpu_torch.models import layers
from playablevideogeneration_tpu_torch.models.layers import BatchNorm
from playablevideogeneration_tpu_torch.models.vgg import make_vgg
from playablevideogeneration_tpu_torch.ops.cuda import build, convlstm_gates
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
from playablevideogeneration_tpu_torch.ops.cuda.nms_sweep import (
    LAUNCHES_PER_CALL as NMS_LAUNCHES_PER_CALL,
    _mask as nms_mask_kernel,
    _nms_keep,
    _packed_rows,
    _sweep as nms_sweep_kernel,
    nms_keep,
)
from playablevideogeneration_tpu_torch.parallel import mesh
from playablevideogeneration_tpu_torch.tools import convergence_soak, gpu_soak, profile_step
from playablevideogeneration_tpu_torch.tools.profile_step import breakdown
from playablevideogeneration_tpu_torch.training.trainer import Trainer
from playablevideogeneration_tpu_torch.utils.checkpoint import STATE_FILE
from playablevideogeneration_tpu_torch.utils.logging import Logger
from playablevideogeneration_tpu_torch.utils import pretrained
from playablevideogeneration_tpu_torch.utils.tensor_ops import sequence_to_nchw
from playablevideogeneration_tpu_torch.utils.pretrained import (
    RANDOM_VGG_SEED,
    load_variables_npz,
    make_metric_vgg,
    save_variables_npz,
)

SEED = 0
# The random VGG19 of the converted weights that phase 10's run loads:
# seeded apart from both fallbacks when no weights are found (the trainer's
# from the run's seed, SEED; the metrics' from RANDOM_VGG_SEED), so that a
# VGG19 equal to the file's was loaded from it.
WEIGHTS_SEED = 5
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
# K4, the greedy NMS of score-sorted boxes (two kernels: the packed IoU >
# threshold rows, then the sweep): it replaces no Pallas kernel but the
# JAX detector's nms_mask after its argsort (the IoU, the threshold and the
# lax.scan), inside its jax.jit.
NMS_KERNEL = dict(name="nms_keep",
                  source="playablevideogeneration_tpu_torch/ops/cuda/csrc/nms_sweep.cu",
                  replaces="playablevideogeneration_tpu/evaluation/metrics/frcnn.py:277")
# K4's sets: a 16-frame detector call takes the four RPN levels of 1000
# candidates of every frame in one nms_keep, P6's 504 (8x21x3 anchors at
# 512x1344) in another and the box stage's 1000 RoIs in a third.
NMS_SHAPES = [(64, 1000), (16, 1000), (16, 504)]
NMS_RAGGED = [(3, 1), (3, 33), (3, 999), (3, 1024)]
NMS_THRESHOLDS = (0.5, 0.7)  # the box stage's and the RPN's
# f32 operations per IoU of two boxes whose areas are known: 2 max and 2
# min, 2 subtractions and 2 clamps for the intersection's sides, its
# product, the union's add, subtract and clamp, the division, the compare.
IOU_OPS = 14
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
# Phase 15's two ranks train on 4 rows each of the loop's batch.
GATE_RANK_SHAPES = [(LOOP_BATCH // 2,) + s[1:] for s in GATE_LOOP_SHAPES]


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
# Phase 12: the seeds of the random Inception (with its 1008-way head) and
# I3D written as converted weights, apart from every other seed here, so
# that backbones equal to the files' were loaded from them; the f32
# card-vs-CPU check's 4 frames and 2 videos; and its tolerance, atol
# BACKBONE_ATOL * max(scale, 0.1) and rtol BACKBONE_RTOL with scale the
# CPU output's largest magnitude: 20 and 50 times tighter than
# tests/test_backbone_parity.py's across backends (2e-3, 5e-3), since in
# f32 without TF32 the card and the CPU differed by at most 7e-7 of the
# scale (3.1e-6 on 4.7 for the features, 5.6e-6 on 7.6 for the embeddings).
INCEPTION_WEIGHTS_SEED, I3D_WEIGHTS_SEED = 12, 13
BACKBONE_PARITY_FRAMES, BACKBONE_PARITY_VIDEOS = 4, 2
BACKBONE_ATOL, BACKBONE_RTOL = 1e-4, 1e-4
# Cold timings rotate over distinct inputs totalling at least this much,
# three times the 50 MB L2, so that each launch finds its inputs in HBM.
COLD_BYTES = 150e6
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


def gate_backward_inputs(shape, dtype, gen, offset: int = 0):
    return gate_inputs(shape, dtype, gen, offset) + tuple(
        on_card(shape, dtype, gen, 1.0, offset) for _ in range(2))  # dh, dc


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
    """Phase 3, K1, K2 and K3; returns the largest error of each kernel.
    The unvectored shape and the views that start one element into their
    buffers must run one element per thread, and each kernel must run
    packs at some flagship shape in each dtype."""
    errors = dict.fromkeys(KERNELS, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        cases = [("convlstm_gates", s, o, gate_inputs(s, dtype, gen, o), fused_lstm_gates,
                  _gate_math)
                 for s, o in [(s, 0) for s in unique(GATE_SHAPES + GATE_TRAIN_SHAPES
                                                     + GATE_LOOP_SHAPES + GATE_RANK_SHAPES
                                                     + GATE_PARITY_SHAPES)]
                 + [(GATE_RAGGED_SHAPE, 0), (UNVECTORED_SHAPE, 0), (GATE_SHAPES[0], 1)]]
        cases += [("convlstm_gates_bwd", s, o, gate_backward_inputs(s, dtype, gen, o),
                   fused_lstm_gates_bwd, _gate_math_bwd)
                  for s, o in [(s, 0) for s in unique(GATE_TRAIN_SHAPES + GATE_LOOP_SHAPES
                                                      + GATE_RANK_SHAPES)]
                  + [(GATE_RAGGED_SHAPE, 0), (UNVECTORED_SHAPE, 0), (GATE_TRAIN_SHAPES[0], 1)]]
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
            # The width the wrapper chose: K1 walks C*H*W of c and gates, K2
            # C*H*W of its inputs and outputs, in packs of GATE_PACK; K3 H*W
            # of x in 16-byte packs.
            if name == "convlstm_gates":
                width = build.vector_width(math.prod(shape[1:]), args[1], args[0],
                                           elements=GATE_PACK)
            elif name == "convlstm_gates_bwd":
                width = build.vector_width(math.prod(shape[1:]), args[1], args[0], *args[2:],
                                           *got, elements=GATE_PACK)
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


def nms_boxes(sets: int, n: int, gen, overlap: str = "random",
              threshold: float = 0.7) -> torch.Tensor:
    """``sets`` seeded sets of ``n`` boxes on the card, taken as in score
    order: random boxes of 2-40 px over 200 px; one box repeated ("all",
    every pair overlapping); boxes side by side ("none"); or ("threshold")
    a W x H box followed by boxes of width x inside it, x stepped an ulp
    at a time around ``threshold`` * W, so that their f32 IoUs with the
    first sit on the f32 threshold and a few hundred ulps either side (W, H
    cycled per set; with n = 2 each set holds one such pair, x stepped
    from set to set)."""
    if overlap == "threshold":
        sizes = [(w, h) for w in (1.0, 10.0, 37.0, 100.0, 640.0) for h in (1.0, 3.0, 7.5)]
        wh = np.array([sizes[i % len(sizes)] for i in range(sets)], np.float32)
        if n == 2:  # the sets of one size take consecutive steps
            steps = (np.arange(sets) // len(sizes))[:, None]
        else:
            steps = np.tile(np.arange(n - 1), (sets, 1))
        steps = steps - steps.max() // 2
        middle = (np.float32(threshold) * wh[:, :1]).astype(np.float32)
        x = (middle.view(np.int32) + steps.astype(np.int32)).view(np.float32)
        boxes = np.zeros((sets, n, 4), np.float32)
        boxes[:, 0, 2:] = wh
        boxes[:, 1:, 2] = x
        boxes[:, 1:, 3] = wh[:, 1:]
        return torch.from_numpy(boxes).cuda()
    centres = torch.rand((sets, n, 2), generator=gen, device="cuda") * 200
    sizes = torch.rand((sets, n, 2), generator=gen, device="cuda") * 38 + 2
    boxes = torch.cat([centres - sizes / 2, centres + sizes / 2], -1)
    if overlap == "all":
        boxes = boxes[:, :1].expand(sets, n, 4).contiguous()
    elif overlap == "none":
        x = torch.arange(n, device="cuda", dtype=torch.float32) * 10
        boxes = torch.stack([x, x * 0, x + 5, x * 0 + 5], -1).expand(sets, n, 4).contiguous()
    return boxes


def plain_rows(boxes: torch.Tensor, threshold: float) -> torch.Tensor:
    """The plain version's packed rows as K4's sweep kernel takes them:
    int32 words, each row padded with zeros to a multiple of 4 words."""
    rows = _packed_rows(boxes, threshold).view(torch.int32)
    return torch.nn.functional.pad(rows, (0, -rows.shape[-1] % 4)).contiguous()


def check_nms(boxes: torch.Tensor, threshold: float, what: str) -> float:
    """K4 (both kernels) on ``boxes`` against its plain version, bit for
    bit (its output is boolean), and its sweep kernel alone on the plain
    version's packed rows (every word written); returns the number of
    differing candidates (0)."""
    got, want = nms_keep(boxes, threshold), _nms_keep(boxes, threshold)
    swept = nms_sweep_kernel(plain_rows(boxes, threshold))
    torch.cuda.synchronize()
    require(got.dtype == torch.bool and got.shape == want.shape and torch.equal(got, want)
            and torch.equal(swept, want),
            f"nms_keep {what} {tuple(boxes.shape)} at {threshold} differs from its plain version")
    return float((got != want).sum().item())


def check_nms_kernel(gen) -> float:
    """Phase 3, K4 at every set shape of a 16-frame detector call and at
    ragged sizes, at both thresholds, with every pair or no pair
    overlapping, and on boxes built to sit at the threshold; returns the
    largest error."""
    err = 0.0
    cases = ([(shape, "random", t) for shape in NMS_SHAPES + NMS_RAGGED for t in NMS_THRESHOLDS]
             + [(NMS_SHAPES[1], "all", 0.7), (NMS_SHAPES[1], "none", 0.7)]
             + [(shape, "threshold", t) for shape in (NMS_SHAPES[1], (1000, 2))
                for t in NMS_THRESHOLDS])
    for (sets, n), overlap, threshold in cases:
        boxes = nms_boxes(sets, n, gen, overlap, threshold)
        err = max(err, check_nms(boxes, threshold, overlap))
        kept = int(_nms_keep(boxes, threshold).sum().item())
        require(overlap != "all" or kept == sets, f"all overlapping: {kept} kept of {sets} sets")
        require(overlap != "none" or kept == sets * n, f"none overlapping: {kept} kept")
        extra = {}
        if overlap == "threshold":
            # The f32 IoUs of the first box with the others against the f32
            # threshold: on it (kept) and either side.
            iou = frcnn.box_iou(boxes[:, :1], boxes[:, 1:])[:, 0]
            t = torch.tensor(threshold, dtype=torch.float32, device="cuda")
            extra = dict(on=int((iou == t).sum()), above=int((iou > t).sum()),
                         below=int((iou < t).sum()))
            require(extra["on"] > 0 and extra["above"] > 0 and extra["below"] > 0, extra)
            if n == 2:
                require(torch.equal(_nms_keep(boxes, threshold)[:, 1], iou[:, 0] <= t),
                        "a pair at the threshold was kept or suppressed wrongly")
        emit(phase="kernel_check", kernel="nms_keep", shape=[sets, n, 4], overlap=overlap,
             threshold=threshold, kept=kept, dtype="f32", max_abs_err=err, **extra)
    return err


def nms_time(boxes: torch.Tensor, threshold: float) -> dict:
    """K4's device time per ``nms_keep`` on ``boxes`` (one set shape of a
    detector call, recorded there), warm (back to back, in L2) and cold
    (rotating over copies of the boxes totalling COLD_BYTES), and its two
    kernels apart (warm), beside its bound and its plain version's time.
    The bound is the larger of the bytes (the boxes read once, the mask
    written once) and the operations (IOU_OPS for each pair i < j of a set
    at the f32 rate); neither counts the sweep's chain of n dependent steps
    per set.  The plain version builds the n x n IoU and steps through the
    candidates with a few launches each, so its time is one call's,
    between CUDA events, after a warm one."""
    sets, n, _ = boxes.shape
    kept = int(_nms_keep(boxes, threshold).sum().item())
    bound, bound_by = bound_ms(boxes.numel() * 4 + sets * n,
                               sets * n * (n - 1) // 2 * IOU_OPS)
    ms = device_ms(lambda: nms_keep(boxes, threshold))
    copies = [boxes] + [boxes.clone()
                        for _ in range(math.ceil(COLD_BYTES / (boxes.numel() * 4)))]
    turn = itertools.cycle(copies)
    cold_ms = device_ms(lambda: nms_keep(next(turn), threshold))
    del copies, turn
    rows = nms_mask_kernel(boxes, threshold)
    mask_ms = device_ms(lambda: nms_mask_kernel(boxes, threshold))
    sweep_ms = device_ms(lambda: nms_sweep_kernel(rows))
    _nms_keep(boxes, threshold)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _nms_keep(boxes, threshold)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    emit(phase="kernel_time", kernel="nms_keep", shape=[sets, n, 4], threshold=threshold,
         kept=kept, us=ms * 1e3, cold_us=cold_ms * 1e3, mask_us=mask_ms * 1e3,
         sweep_us=sweep_ms * 1e3, bound_us=bound * 1e3, bound_by=bound_by,
         plain_us=plain_ms * 1e3, bound_share_cold=bound / cold_ms)
    return dict(ms=ms, cold_ms=cold_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                mask_ms=mask_ms, sweep_ms=sweep_ms)


def check_gate_autograd(gen) -> None:
    """Phase 3, the gate update's autograd function (K1 forward, K2
    backward) against autograd through the plain gate math, which
    differentiates sigmoid and tanh in its own order of operations: 1e-5
    in f32."""
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


class EagerPlay:
    """The play route op by op, as ``PlaySession`` ran it before its steps
    became graph replays: ``model.play_step`` chained from one state, the
    variations drawn from a generator seeded like the session's (one row
    per step, N rows at once for a rollout).  The graphed session is held
    against it bit for bit (phase 18) and timed beside it (phase 6)."""

    def __init__(self, model, obs: np.ndarray, noise: bool = False, seed: int = SEED):
        self.model, self.noise = model, noise
        self.generator = torch.Generator(device="cuda").manual_seed(seed)
        self.eye = torch.eye(model.actions_count, device="cuda")
        self.carry = model.init_play(1)
        self.window = torch.as_tensor(obs)[None].to("cuda", model.dtype)

    def variations(self, count: int) -> torch.Tensor:
        shape = (count, self.model.action_space_dimension)
        if self.noise:
            return torch.randn(shape, generator=self.generator, device="cuda")
        return torch.zeros(shape, device="cuda")

    def step(self, action: int, variation=None) -> torch.Tensor:
        """The (H, W, 3) frame in the model dtype, on the card."""
        variation = self.variations(1) if variation is None else variation
        self.carry, frame, self.window = self.model.play_step(
            self.carry, self.window, self.eye[action:action + 1], variation)
        return frame[0]

    def interpolation(self, first: int, second: int, factor: float) -> torch.Tensor:
        centroids = self.model.centroids
        selected = second if factor > 0.5 else first
        interpolated = (centroids[second] - centroids[first]) * factor + centroids[first]
        return self.step(selected, (interpolated - centroids[selected])[None])

    def rollout(self, actions) -> np.ndarray:
        variations = self.variations(len(actions))
        return torch.stack([to_uint8(self.step(int(a), variations[i:i + 1]))
                            for i, a in enumerate(actions)]).cpu().numpy()


def to_uint8(frame: torch.Tensor) -> torch.Tensor:
    return ((frame.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)


def profile_steps(step, steps: int = 10) -> tuple:
    """``steps`` synchronised calls of ``step`` under ``torch.profiler``:
    (kernels as (name, ms, calls) per step by time, host ms per step)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = sorted(((e.key, e.device_time_total / steps / 1e3, e.count / steps)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda k: -k[1])
    return kernels, wall_ms


def synchronised_ms(call, count: int, warm: int = 5) -> list:
    times = []
    for i in range(count + warm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(i)
        torch.cuda.synchronize()
        if i >= warm:
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def route_times(step, interactive, rollout, profiled) -> tuple:
    """One way of playing timed: ``step(i)`` synchronised (play_step_ms,
    median and p90), ``interactive(i)`` (interactive_u8_ms, ending in its
    own readback), ``rollout()`` of ROLLOUT_FRAMES (rollout_fps, median of
    3), and ``profiled()`` (one step) under the profiler for the kernels
    per step, the device's busy time and its idle share against the
    unprofiled step; returns (metrics, kernels)."""
    step_ms = synchronised_ms(step, TIMED_STEPS)
    rollout()  # a graphed rollout captures at its first call
    interactive_ms = []
    for i in range(TIMED_STEPS + 5):
        t0 = time.perf_counter()
        interactive(i)
        if i >= 5:
            interactive_ms.append((time.perf_counter() - t0) * 1e3)
    rollout_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout()
        rollout_s.append(time.perf_counter() - t0)
    kernels, wall_ms = profile_steps(profiled)
    busy_ms = sum(k[1] for k in kernels) if kernels else None
    play_step_ms = statistics.median(step_ms)
    # The idle share sets the profiled device time against the unprofiled
    # step, since the profiler slows the host.
    return dict(play_step_ms=play_step_ms, play_step_p90_ms=float(np.percentile(step_ms, 90)),
                interactive_u8_ms=statistics.median(interactive_ms),
                interactive_u8_p90_ms=float(np.percentile(interactive_ms, 90)),
                rollout_fps=ROLLOUT_FRAMES / statistics.median(rollout_s),
                rollout_fps_all=[ROLLOUT_FRAMES / s for s in rollout_s],
                profiled_step_wall_ms=wall_ms, step_device_busy_ms=busy_ms,
                device_idle_share=None if busy_ms is None else 1 - busy_ms / play_step_ms,
                kernels_per_step=sum(k[2] for k in kernels)), kernels


def time_route(model, obs: np.ndarray, actions: np.ndarray) -> dict:
    """Phase 6b: the play route on the bf16 flagship both ways, graphed
    through ``PlaySession`` (a step is ``generate_next_u8(block=False)``:
    the two input copies, the replay and the uint8 frame's copy on the
    card) and eager (``model.play_step`` alone, the uint8 conversion and
    readback after it, the rollout's steps one by one): latency, frame
    rate, kernels and device time per step.  A graph's kernels reach the
    profiler as kernels of their own, without the ``aten`` operators that
    launched them at capture; the breakdown groups them by name."""
    session = PlaySession(model).start(obs)
    eager = EagerPlay(model, obs)
    pick = lambda i: int(actions[i % len(actions)])  # noqa: E731
    graphed, graphed_kernels = route_times(
        lambda i: session.generate_next_u8(pick(i), block=False),
        lambda i: session.generate_next_u8(pick(i)),
        lambda: session.rollout(actions[:ROLLOUT_FRAMES]),
        lambda: session.generate_next_u8(1, block=False))
    carry, window = eager.carry, eager.window
    onehot, variation = eager.eye[:1], eager.variations(1)

    def bare_step(_):
        nonlocal carry, window
        carry, _frame, window = model.play_step(carry, window, onehot, variation)

    op_by_op, eager_kernels = route_times(
        bare_step, lambda i: to_uint8(eager.step(pick(i))).cpu().numpy(),
        lambda: eager.rollout(actions[:ROLLOUT_FRAMES]), lambda: bare_step(0))
    route = dict(graphed=graphed, eager=op_by_op,
                 play_step_speedup=op_by_op["play_step_ms"] / graphed["play_step_ms"],
                 rollout_speedup=graphed["rollout_fps"] / op_by_op["rollout_fps"],
                 card=nvidia_smi())
    emit(phase="route_time", dtype="bf16", **route)
    emit(phase="step_breakdown", graphed=breakdown(graphed_kernels, 20),
         eager=breakdown(eager_kernels, 20))
    return route


def reset_launches() -> None:
    """Sets every kernel's count to 0 (``read_launches`` reads K1-K3's;
    K4 runs in the detector alone, which reads its own)."""
    fused_lstm_gates.launches = 0
    fused_lstm_gates_bwd.launches = 0
    fused_batch_norm_leaky_relu.launches = 0
    nms_keep.launches = 0


def read_launches() -> dict:
    return {"convlstm_gates": fused_lstm_gates.launches,
            "convlstm_gates_bwd": fused_lstm_gates_bwd.launches,
            "fused_norm_act": fused_batch_norm_leaky_relu.launches}


def flagship_trainer(backend=None) -> Trainer:
    """The bf16 flagship trainer at batch 16 x 12 frames; ``backend`` is the
    trainer's seam (``graphs.Eager`` for the op-by-op step)."""
    return build_synthetic_trainer(
        height=256, width=256, batch_size=TRAIN_BATCH, observations_count=TRAIN_FRAMES,
        compute_dtype="bfloat16", remat=True, smooth_mi=True, pretraining_steps=1,
        device="cuda", seed=SEED, backend=backend)


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
    keys = set()
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
        keys.add((metrics["pretraining"], metrics["ground_truth_observations"]))
        require(trainer.captures == len(keys),
                f"step {step + 1}: {trainer.captures} captures for {len(keys)} keys")
        emit(phase="train_step", step=step + 1, pretraining=bool(metrics["pretraining"]),
             loss=metrics["loss"], ground_truth_observations=metrics["ground_truth_observations"],
             gumbel_temperature=metrics["gumbel_temperature"], launches=launches, **norms)
    after = by_module()
    changed = {name: float((after[name] - before[name]).abs().max()) for name in before}
    require(all(v > 0 for v in changed.values()), f"parameters unchanged: {changed}")
    emit(phase="train_route", steps=4, launches=totals, max_parameter_change=changed,
         graphed=True, captures=trainer.captures)
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
        # Op by op on the card too: both draw their noise from a CPU
        # generator, which a CUDA graph cannot replay.
        trainer = Trainer(config, flagship_model(device, torch.float32, SEED,
                                                 checkpoint_steps=True),
                          smooth_mi=True, seed=SEED, backend=graphs.Eager)
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


def time_train(trainer: Trainer, batch, way: str) -> dict:
    """Phase 9b: median full-phase train step, frames per second, peak
    memory, and the device's busy share over two profiled steps, ``way``
    naming the trainer's route (``graphed`` or ``eager``).  A graphed step
    allocates nothing: its peak is what lives beside the graph's pool, the
    pool being allocated when it was captured."""
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
    emit(phase="train_time", dtype="bf16", way=way, **route)
    emit(phase="train_step_breakdown", way=way, **breakdown(kernels, 25))
    return route


def time_train_both_ways(graphed: Trainer, batch) -> dict:
    """Phase 9b both ways: ``graphed`` (phase 7's trainer, past its
    captures), then the op-by-op trainer from the same seed past its
    pretraining step, as phase 6 times the play route both ways."""
    route = {"graphed": time_train(graphed, batch, "graphed")}
    eager = flagship_trainer(graphs.Eager)
    for _ in range(2):  # pretraining, then the first full-phase step
        eager.train_step(batch)
    route["eager"] = time_train(eager, batch, "eager")
    del eager
    emit(phase="train_time_both_ways", graphed_ms=route["graphed"]["train_step_ms"],
         eager_ms=route["eager"]["train_step_ms"],
         speedup=route["eager"]["train_step_ms"] / route["graphed"]["train_step_ms"],
         card=nvidia_smi())
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
    """Within the block, every ``Trainer.train_step``, evaluation batch
    (``Evaluator._batch``: the forward and the metrics, a replay on the
    card) and evaluation pass is recorded: its kernel launches, wall time
    and metrics, and for a step the schedules' values at its global
    step."""

    def __enter__(self):
        self.steps, self.forwards, self.passes = [], [], []
        self._saved = Trainer.train_step, Evaluator._batch, Evaluator.evaluate
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

        def recorded_forward(evaluator, observations, actions):
            before = read_launches()
            out = forward(evaluator, observations, actions)
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
        Evaluator._batch = recorded_forward
        Evaluator.evaluate = recorded_evaluate
        return self

    def __exit__(self, *exc_info):
        Trainer.train_step, Evaluator._batch, Evaluator.evaluate = self._saved


def state_snapshot(trainer: Trainer) -> dict:
    """The training state in full tensors (under tensor parallelism every
    rank of the model group gathers the sharded ones), copied to the host:
    parameters and buffers, Adam's slots and groups, the schedule, the MI
    matrix, the steps."""
    state = trainer.state.state_dict()
    optimizer = state["optimizer"]
    return dict(
        model={k: v.detach().cpu().clone() for k, v in state["model"].items()},
        adam={(i, name): v.detach().cpu().clone() for i, slots in optimizer["state"].items()
              for name, v in slots.items()},
        param_groups=optimizer["param_groups"], scheduler=trainer.state.scheduler.state_dict(),
        mi_matrix=trainer.state.mi_matrix.cpu().clone(), step=trainer.state.step,
        global_step=trainer.global_step)


def require_configured_vgg(config: dict, trainer: Trainer, evaluators: dict) -> None:
    """The converted VGG19 that phase 10's config names, loaded bit for bit
    by the run's trainer (computing in the model's dtype) and by a run's
    two evaluators (one VGG19, in f32); the file's weights differ from both
    seeded fallbacks."""
    params = load_variables_npz(os.path.join(config["tpu"]["pretrained_weights_dir"],
                                             "vgg19.npz"))["params"]
    want = {f"{name}.{key}": torch.from_numpy(
        value.transpose(3, 2, 0, 1) if key == "kernel" else value)
        for name, conv in params.items() for key, value in conv.items()}
    dtype = trainer.model.dtype
    require(evaluators["validation"].vgg is evaluators["test"].vgg,
            "the evaluators do not share one VGG19")
    for fallback in (make_vgg("cpu", dtype, SEED), make_metric_vgg(None, "cpu")):
        require(not torch.equal(fallback.conv0.weight, want["conv0.kernel"]),
                "the file's VGG19 is a seeded fallback's")
    for what, vgg, compute in (("trainer", trainer.vgg, dtype),
                               ("evaluators", evaluators["validation"].vgg, torch.float32)):
        got = {k.replace("weight", "kernel"): v.cpu() for k, v in vgg.state_dict().items()}
        require(got.keys() == want.keys(), f"{what}: VGG19 tensors {sorted(got)}")
        require(all(torch.equal(got[k], want[k]) for k in want),
                f"{what}: the VGG19 is not the configured vgg19.npz")
        require(all(conv.compute_dtype == compute for conv in vgg.children()),
                f"{what}: the VGG19 does not compute in {compute}")
    emit(phase="loop_vgg", weights_seed=WEIGHTS_SEED, trainer_dtype=str(dtype),
         evaluators_dtype="torch.float32", bit_exact=True, shared_by_evaluators=True)


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


def train_loop(root: str) -> tuple:
    """Phase 10: BAIR's config (LOOP_OVERRIDES) through ``cli.train.train``
    on in-memory synthetic videos: 2 pretraining and 4 full-phase steps,
    checkpoints, the three evaluation passes; the state restored exactly by
    a fresh run; a resumed run's 2 more steps; then, on the evaluated
    trainer, two profiled loop steps and bare ``train_step``s.  Returns the
    two runs' launch counts and the loop's step period in ms."""
    from torch.profiler import ProfilerActivity, profile

    # The defaults, which phases 5 and 8 turned off: a run's f32
    # convolutions (the evaluator's VGG) take TF32.
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    config = loop_config(root)
    config["tpu"]["pretrained_weights_dir"] = os.path.join(root, "vgg")
    gpu_soak.write_vgg_weights(os.path.join(root, "vgg", "vgg19.npz"), WEIGHTS_SEED)
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
        _, _, restored, evaluators, _ = build_run(config, device="cuda", datasets=datasets)
        require_configured_vgg(config, trainer, evaluators)
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
        # host as the loader gives it.  The profiled steps replay a graph
        # captured anew, in an unprofiled loop step: with PyTorch 2.11 and
        # CUDA 12.8 the profiled launch of a graph captured before the run's
        # evaluator and its graphs were freed crashed the process (a
        # segmentation fault in CUDAGraph.replay), and one captured after
        # that ran.
        trainer.drop_program()
        trainer.train_epoch(max_steps=trainer.global_step + 1)
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
    return launches, loop_step_ms


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
    """Random, seeded ``vgg19.npz`` (the metrics' fallback's weights) and
    ``lpips_lin.npz`` in the converter's layout (one (C,) head per level),
    so that the pretrained VGG19 and LPIPS run."""
    gpu_soak.write_vgg_weights(os.path.join(directory, "vgg19.npz"), RANDOM_VGG_SEED)
    gpu_soak.write_lpips_weights(os.path.join(directory, "lpips_lin.npz"), SEED)


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
    five metrics with VGG19, and LPIPS: one graph replay and its readback
    on the card) and the whole ``compute_metrics`` are timed."""

    def __enter__(self):
        self.frame_s, self.total_s = [], []
        self._saved = DatasetEvaluator._compute_frame_metrics, DatasetEvaluator.compute_metrics
        frame_metrics, compute_metrics = self._saved
        recorder = self

        def recorded_frame_metrics(evaluator, reference, generated):
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
    Returns the launch counts of its first five steps, the evaluation
    config and the (test split, builder videos) dataset pair."""
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
    frame_s = sum(timing.frame_s)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    emit(phase="after_evaluation", batches=batches, keys=len(metrics),
         seconds=timing.total_s[0], seconds_per_batch=timing.total_s[0] / batches,
         frame_metrics_s_per_batch=frame_s / batches,
         frame_metrics_s_first_batch=timing.frame_s[0],
         host_loader_detection_actions_s_per_batch=(timing.total_s[0] - frame_s) / batches,
         psnr_avg=metrics["psnr/avg"], ssim_avg=metrics["ssim/avg"],
         lpips_avg=metrics["lpips/avg"], vgg_sim_avg=metrics["vgg_sim/avg"],
         markers=sorted(k for k in metrics if k.endswith("_unavailable")),
         peak_memory_gib=peak_gib, allocated_before_gib=evaluation_base_gib,
         card=nvidia_smi())

    frame_metrics_both_ways(eval_config, pair)

    # 7. f32 with TF32 off, the card against the plain path on the CPU: one
    # builder batch of 2 x 8 frames, and one evaluation batch's metrics.
    after_training_parity(config, eval_config, source.state_dict(), test_videos, pair)
    emit(phase="after_training", launches=totals)
    return totals, eval_config, pair


def host_transfers(call) -> int:
    """The synchronising CUDA operations of one call: a copy from pageable
    host memory to the card and a readback each synchronise, a replay does
    not."""
    with counted_syncs() as syncs:
        call()
    return len(syncs)


def both_ways(graphed, eager, args: tuple, what: str, copies_in: int) -> dict:
    """A graphed function against its op-by-op twin (``graphs.Eager``) on
    ``args``: the first graphed call captures, the next ones make
    ``copies_in`` copies to the card and one readback and nothing else
    that synchronises; one is profiled right after the capture; the
    outputs bit for bit; both ways timed on the host's clock (median of 3
    after one), each call ending in its readback."""
    got = graphed(*args)
    graphed_activity = device_activity(lambda: graphed(*args))
    transfers = host_transfers(lambda: graphed(*args))
    require(transfers == copies_in + 1,
            f"{what}: a graphed call synchronised {transfers} times, not {copies_in + 1}")
    require_same_outputs(got, eager(*args), what)
    eager_activity = device_activity(lambda: eager(*args))
    graphed_ms = synchronised_ms(lambda i: graphed(*args), 3, warm=1)
    eager_ms = synchronised_ms(lambda i: eager(*args), 3, warm=1)
    return dict(bit_for_bit=True, graphed_host_transfers=transfers,
                graphed_ms=statistics.median(graphed_ms),
                eager_ms=statistics.median(eager_ms), graphed_ms_all=graphed_ms,
                eager_ms_all=eager_ms, graphed_kernels=graphed_activity["kernels"],
                eager_kernels=eager_activity["kernels"],
                graphed_copies=graphed_activity["copies"],
                eager_copies=eager_activity["copies"],
                graphed_busy_ms=graphed_activity["busy_ms"], graphed_top=graphed_activity["top"],
                eager_busy_ms=eager_activity["busy_ms"])


def frame_metrics_both_ways(eval_config: dict, pair: tuple) -> None:
    """Phase 11, step 6: one 1 x 30 evaluation batch's frame metrics (the
    converted-layout VGG19 and LPIPS) graphed, the evaluator's default on
    the card, against op by op (``graphs.Eager``): bit for bit, two copies
    in and one out per graphed call, both ways timed and profiled; and
    LPIPS alone op by op, its share of a batch."""
    weights = eval_config["tpu"]["pretrained_weights_dir"]
    tree = load_variables_npz(os.path.join(weights, "vgg19.npz"))
    heads = load_lpips_linear_weights(os.path.join(weights, "lpips_lin.npz"))
    reference, generated = collate([pair[0][0]]), collate([pair[1][0]])
    args = (reference.observations, generated.observations)
    gc.collect()  # no graph captured before the profiled one is freed after it

    def evaluator(backend):
        return DatasetEvaluatorBair(
            eval_config, Logger(), *pair, vgg_variables=tree,
            lpips_fn=make_lpips_fn(make_metric_vgg(tree, "cuda"), heads), device="cuda",
            backend=backend)

    graphed, eager = evaluator(None), evaluator(graphs.Eager)
    ways = both_ways(graphed._compute_frame_metrics, eager._compute_frame_metrics, args,
                     "the frame metrics", copies_in=2)
    ref, gen = (torch.as_tensor(x, device="cuda") for x in args)
    with torch.no_grad():
        lpips_ms = synchronised_ms(lambda i: eager.lpips_fn(ref, gen), 3, warm=1)
    emit(phase="after_frame_metrics_both_ways", batch=list(args[0].shape[:2]),
         lpips_eager_ms=statistics.median(lpips_ms),
         tf32=torch.backends.cudnn.allow_tf32, **ways)


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


class DistributionRecorder:
    """Within the block: the backbones that ``evaluation_backbones`` builds
    (``backbones``), each call of the FID extractor, the class-probability
    function and the FVD embedder timed on the host's clock (each ends in a
    readback, so the time holds the input's copy to the card, the device's
    work and the readback), and each ``scipy.linalg.sqrtm`` with its
    matrix's size."""

    def __enter__(self):
        import scipy.linalg

        self.backbones, self.calls, self.sqrtm = {}, {}, []
        self._saved = pretrained.evaluation_backbones, scipy.linalg.sqrtm
        find, sqrtm = self._saved
        recorder = self

        def timed(name, fn):
            def call(x):
                start = time.perf_counter()
                out = fn(x)
                recorder.calls.setdefault(name, []).append(
                    (len(x), (time.perf_counter() - start) * 1e3))
                return out
            call.__dict__.update(fn.__dict__)
            return call

        def recorded_backbones(*args, **kwargs):
            found = find(*args, **kwargs)
            recorder.backbones = dict(found)
            for name in ("fid_extractor", "class_probability_fn", "fvd_embedder"):
                if found[name] is not None:
                    found[name] = timed(name, found[name])
            return found

        def timed_sqrtm(a, *args, **kwargs):
            start = time.perf_counter()
            out = sqrtm(a, *args, **kwargs)
            recorder.sqrtm.append((a.shape[0], time.perf_counter() - start))
            return out

        pretrained.evaluation_backbones = recorded_backbones
        scipy.linalg.sqrtm = timed_sqrtm
        return self

    def __exit__(self, *exc_info):
        import scipy.linalg

        pretrained.evaluation_backbones, scipy.linalg.sqrtm = self._saved


def require_same_weights(model: torch.nn.Module, want: torch.nn.Module, what: str) -> int:
    """Every tensor of ``model`` equals ``want``'s bit for bit; returns the
    number of tensors."""
    got, expected = model.state_dict(), want.state_dict()
    require(list(got) == list(expected), f"{what}: the tensors differ")
    for key, value in expected.items():
        require(torch.equal(got[key].cpu(), value.cpu()), f"{what}: {key} is not the file's")
    return len(expected)


def backbone_error(got: np.ndarray, want: np.ndarray, what: str, atol=None,
                   rtol: float = BACKBONE_RTOL) -> dict:
    """The card's output against the CPU's, by default within atol
    BACKBONE_ATOL * max(scale, 0.1) and rtol BACKBONE_RTOL; returns the
    largest absolute error and its ratio to the allowed absolute error."""
    scale = float(np.abs(want).max())
    require(got.shape == want.shape and np.isfinite(got).all() and scale > 0,
            f"{what}: shape {got.shape}, scale {scale}")
    if atol is None:
        atol = BACKBONE_ATOL * max(scale, 0.1)
    err = float(np.abs(got - want).max())
    require((np.abs(got - want) <= atol + rtol * np.abs(want)).all(),
            f"{what} on the card differs from the CPU by {err} (scale {scale}, atol {atol}, "
            f"rtol {rtol})")
    return dict(max_abs_err=err, scale=scale, atol=atol, rtol=rtol, err_over_atol=err / atol)


def fid_printed(argv: list) -> float:
    """``cli.fid.main(argv)``'s distance, read from what it prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fid_cli.main(argv)
    printed = out.getvalue()
    require(printed.startswith("FID: "), printed)
    return float(printed.split("FID: ")[1])


def distribution_metrics(root: str, eval_config: dict, pair: tuple) -> None:
    """Phase 12, on phase 11's dataset pair (2 x 8 builder videos of 30
    frames against the test split) and BAIR's evaluation config with the
    Inception Score on: random ``fid_inception.npz`` (with its 1008-way
    ``fc``) and ``i3d.npz`` in the converter's layout beside phase 11's
    VGG19 and LPIPS files; ``cli.evaluate_dataset`` at the full input
    sizes (299, 224) with the port's defaults (cuDNN's TF32 on) gives FID
    and Inception Score over 480 frames and FVD over 16 videos; the
    backbones hold the files' weights bit for bit; ``cli.fid`` on the two
    datasets' statistics prints the evaluator's FID; FID and FVD again
    with TF32 off; and in f32 with TF32 off, the card against the CPU:
    Inception's features and class probabilities of 4 frames, I3D's
    embeddings of 2 videos.  The path runs no kernel of the port."""
    torch.backends.cudnn.allow_tf32 = True  # the port's defaults, which phase 11 turned off
    torch.backends.cuda.matmul.allow_tf32 = False
    weights = eval_config["tpu"]["pretrained_weights_dir"]
    paths = {"fid_inception": os.path.join(weights, "fid_inception.npz"),
             "i3d": os.path.join(weights, "i3d.npz")}
    save_variables_npz(random_inception_variables(INCEPTION_WEIGHTS_SEED), paths["fid_inception"])
    save_variables_npz(random_i3d_variables(I3D_WEIGHTS_SEED), paths["i3d"])
    files = {name: load_variables_npz(path) for name, path in paths.items()}
    config = copy.deepcopy(eval_config)
    config["evaluation"]["compute_inception_score"] = True
    config["logging"]["output_root"] = os.path.join(root, "distribution_results")
    EvaluationConfiguration(config=config).check_config(check_data_root=False)

    # 1. The evaluation with every backbone, at the port's defaults.
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    with DistributionRecorder() as recorder:
        start = time.perf_counter()
        metrics = evaluate_dataset(config, device="cuda", datasets=pair)
        evaluation_s = time.perf_counter() - start
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = read_launches()
    require(not any(launches.values()), f"the distribution metrics launched {launches}")
    for key in ("fid", "fvd", "inception_score", "inception_score_std"):
        require(key in metrics and math.isfinite(metrics[key]), f"{key}: {metrics.get(key)}")
    markers = [k for k in ("fid_unavailable", "fvd_unavailable", "inception_score_unavailable")
               if k in metrics]
    require(not markers, f"markers with every backbone present: {markers}")
    frames = len(pair[0]) * EVAL_FRAMES
    calls = recorder.calls
    require([n for n, _ in calls["fid_extractor"]] == [EVAL_FRAMES] * (2 * len(pair[0]))
            and [n for n, _ in calls["class_probability_fn"]] == [EVAL_FRAMES] * len(pair[1])
            and [n for n, _ in calls["fvd_embedder"]] == [len(pair[0]), len(pair[1])],
            f"backbone calls {({k: [n for n, _ in v] for k, v in calls.items()})}")
    sqrtm = {}
    for size, seconds in recorder.sqrtm:
        sqrtm.setdefault(str(size), []).append(seconds)
    require(sorted(sqrtm) == ["2048", "400"], f"sqrtm sizes {sorted(sqrtm)}")

    # 2. The backbones are the files' weights, bit for bit.
    backbones = recorder.backbones
    tensors = {
        "inception": require_same_weights(backbones["fid_extractor"].model, make_inception(
            files["fid_inception"], "cpu"), "the FID extractor"),
        "inception_score": require_same_weights(
            backbones["class_probability_fn"].model,
            make_inception(files["fid_inception"], "cpu"), "the Inception Score's backbone"),
        "i3d": require_same_weights(backbones["fvd_embedder"].model,
                                    make_i3d(files["i3d"], "cpu"), "the FVD embedder")}
    head = backbones["class_probability_fn"].head
    fc = files["fid_inception"]["params"]["fc"]
    require(torch.equal(head.weight.cpu(), torch.from_numpy(fc["kernel"].T.copy()))
            and torch.equal(head.bias.cpu(), torch.from_numpy(fc["bias"])),
            "the Inception Score's head is not the file's")
    emit(phase="distribution_evaluation", frames=frames, videos=len(pair[0]),
         fid=metrics["fid"], fvd=metrics["fvd"], inception_score=metrics["inception_score"],
         inception_score_std=metrics["inception_score_std"], launches=launches,
         bit_exact_tensors=tensors, weights_seeds=[INCEPTION_WEIGHTS_SEED, I3D_WEIGHTS_SEED],
         seconds=evaluation_s, peak_memory_gib=peak_gib, allocated_before_gib=base_gib,
         inception_ms_per_batch=statistics.median(ms for _, ms in calls["fid_extractor"]),
         inception_ms_first=calls["fid_extractor"][0][1],
         class_probability_ms_per_batch=statistics.median(
             ms for _, ms in calls["class_probability_fn"]),
         i3d_ms_per_call=[ms for _, ms in calls["fvd_embedder"]],
         backbone_s=sum(ms for v in calls.values() for _, ms in v) / 1e3,
         sqrtm_s=sqrtm, tf32=True, card=nvidia_smi())

    # 3. cli.fid on the two datasets' statistics, written with the card's
    # extractor, against the evaluator's FID; --weights resolves the file.
    evaluator = DatasetEvaluatorBair(config, Logger(), *pair, device="cuda",
                                     fid_extractor=backbones["fid_extractor"],
                                     fvd_embedder=backbones["fvd_embedder"])
    statistics_paths = []
    for name, loader in (("reference", evaluator.reference_dataloader),
                         ("generated", evaluator.generated_dataloader)):
        mu, sigma = compute_statistics_from_frames(backbones["fid_extractor"],
                                                   evaluator._iter_frames(loader))
        statistics_paths.append(os.path.join(root, f"{name}_statistics.npz"))
        np.savez(statistics_paths[-1], mu=mu, sigma=sigma)
    cli_fid = fid_printed(statistics_paths)
    cli_rel = abs(cli_fid - metrics["fid"]) / abs(metrics["fid"])
    require(cli_rel <= 1e-9, f"cli.fid printed {cli_fid}, the evaluator {metrics['fid']}")
    found = []
    get_fid_extractor = pretrained.get_fid_extractor

    def recorded_get(config, **kwargs):
        found.append(pretrained.find_weights(config, "fid_inception"))
        return get_fid_extractor(config, **kwargs)

    pretrained.get_fid_extractor = recorded_get
    try:
        weights_fid = fid_printed(statistics_paths + ["--weights", paths["fid_inception"],
                                                      "--device", "cuda"])
    finally:
        pretrained.get_fid_extractor = get_fid_extractor
    require(found == [paths["fid_inception"]] and weights_fid == cli_fid,
            f"--weights resolved {found}, printed {weights_fid}")

    # 4. FID and FVD again with TF32 off.
    torch.backends.cudnn.allow_tf32 = False
    fid_off, fvd_off = evaluator._compute_fid(), evaluator._compute_fvd()
    emit(phase="distribution_cli_and_tf32", cli_fid=cli_fid, cli_fid_rel_err=cli_rel,
         weights_resolved=True, fid_tf32_on=metrics["fid"], fid_tf32_off=fid_off,
         fid_rel_change=fid_off / metrics["fid"] - 1, fvd_tf32_on=metrics["fvd"],
         fvd_tf32_off=fvd_off, fvd_rel_change=fvd_off / metrics["fvd"] - 1)

    # 5. Graphed against op by op (graphs.Eager) with TF32 off: a fresh
    # graph of each backbone, on one evaluation batch's 30 frames and on
    # the 16 reference videos.
    del evaluator
    for name in ("fid_extractor", "class_probability_fn", "fvd_embedder"):
        backbones[name].programs.clear()  # their pools go before the next captures
    gc.collect()  # no graph captured before the profiled ones is freed after them
    frames30 = collate([pair[0][0]]).observations[0]
    videos16 = collate([pair[0][i] for i in range(len(pair[0]))]).observations
    ways = {}
    for name, make, weights_file, x in (
            ("fid_extractor", make_fid_extractor, "fid_inception", frames30),
            ("class_probability_fn", make_class_probability_fn, "fid_inception", frames30),
            ("fvd_embedder", make_fvd_embedder, "i3d", videos16)):
        ways[name] = both_ways(make(files[weights_file], "cuda"),
                               make(files[weights_file], "cuda", backend=graphs.Eager), (x,),
                               name, copies_in=1)
        ways[name]["input"] = list(x.shape)
    emit(phase="distribution_both_ways", tf32=False, **ways)
    del videos16

    # 6. f32 with TF32 off: the card's backbones against the CPU's.
    sample = collate([pair[0][0], pair[1][0]]).observations  # (2, 30, 256, 256, 3)
    images = sample[0, :BACKBONE_PARITY_FRAMES]
    videos = sample[:BACKBONE_PARITY_VIDEOS]
    cpu = {"features": make_fid_extractor(files["fid_inception"], "cpu")(images),
           "probabilities": make_class_probability_fn(files["fid_inception"], "cpu")(images),
           "embeddings": make_fvd_embedder(files["i3d"], "cpu")(videos)}
    card = {"features": backbones["fid_extractor"](images),
            "probabilities": backbones["class_probability_fn"](images),
            "embeddings": backbones["fvd_embedder"](videos)}
    # The probabilities (about 1/1008 each) within 1e-5, as the CPU tests
    # hold them to the JAX package's.
    errors = {name: backbone_error(card[name], cpu[name], name,
                                   **(dict(atol=1e-5, rtol=0.0) if name == "probabilities"
                                      else {}))
              for name in cpu}
    torch.backends.cudnn.allow_tf32 = True
    emit(phase="distribution_parity", dtype="f32", tf32=False, frames=BACKBONE_PARITY_FRAMES,
         videos=list(videos.shape[:2]), errors=errors)


# Phase 13: the convergence soak on the breakout_fixed_row setting of
# docs/CONVERGENCE.md (3 actions, 1-D direction latent, the square's row
# pinned), at the tool's defaults (48x48 frames, hidden 32, batch 16, 6
# frames, bf16), cut to 20 pretraining and 80 full-phase steps with an
# evaluation every 50, in two runs of one root; its evaluation batches of
# 8 x 6 frames, 8 per pass.
SOAK_STEPS, SOAK_FIRST_STOP = 100, 50
SOAK_ARGS = ["--actions", "3", "--action-space-dimension", "1", "--fixed-y",
             "--steps", str(SOAK_STEPS), "--pretraining-steps", "20",
             "--eval-every", str(SOAK_FIRST_STOP), "--no-example-images"]
SOAK_FRAMES, SOAK_EVAL_BATCH, SOAK_EVAL_BATCHES = 6, 8, 8
# Phase 14: the Faster R-CNN detector on tennis-shaped frames (96x256, as
# configs/03_tennis.yaml's videos), one 16-frame sequence at the default
# 800/1333 transform (500x1333, padded to 512x1344); random weights in the
# converter's layout from a seed of their own, the box head's person bias
# raised so that the RoIs' person scores spread over the 0.05 and 0.8
# thresholds (random weights score every class near 1/91); the f32
# card-vs-CPU check at a transform of 32/86 (32x85), where no top-k cuts a
# level's candidates.
FRCNN_WEIGHTS_SEED = 14
FRCNN_PERSON_BIAS = 4.5
FRCNN_FRAMES, FRCNN_HEIGHT, FRCNN_WIDTH = 16, 96, 256
FRCNN_PARITY_FRAMES, FRCNN_PARITY_RESIZE = 4, (32, 86)
FRCNN_TIMED_CALLS = 3
# Scores (probabilities) and boxes (pixels of the input) held card against
# CPU; the features by backbone_error's atol and rtol.
FRCNN_SCORE_ATOL, FRCNN_BOX_ATOL = 1e-4, 1e-2


class KernelShapes:
    """Within the block, the (shape, dtype) of every call of K1, K2 and K3
    (each kernel's wrapper as the model calls it)."""

    def __enter__(self):
        self.shapes = {name: set() for name in KERNELS}
        self._saved = (convlstm_gates._forward, convlstm_gates._FusedGates.backward,
                       layers.fused_batch_norm_leaky_relu)
        forward, backward, norm = self._saved
        shapes = self.shapes

        def gates(g, c):
            shapes["convlstm_gates"].add((tuple(c.shape), c.dtype))
            return forward(g, c)

        def gates_bwd(ctx, dh, dc):  # dh has c's shape and dtype
            shapes["convlstm_gates_bwd"].add((tuple(dh.shape), dh.dtype))
            return backward(ctx, dh, dc)

        def batch_norm(x, *statistics):
            shapes["fused_norm_act"].add((tuple(x.shape), x.dtype))
            return norm(x, *statistics)

        # The wrappers count their launches under their own module-level
        # names, which stay in place.
        convlstm_gates._forward = gates
        convlstm_gates._FusedGates.backward = staticmethod(gates_bwd)
        layers.fused_batch_norm_leaky_relu = batch_norm
        return self

    def __exit__(self, *exc_info):
        convlstm_gates._forward, backward, layers.fused_batch_norm_leaky_relu = self._saved
        convlstm_gates._FusedGates.backward = staticmethod(backward)


def check_kernels_at(shapes: dict, gen) -> dict:
    """K1, K2 and K3 bit for bit against their plain versions at each
    recorded (shape, dtype); returns the largest error of each."""
    cases = {"convlstm_gates": (gate_inputs, fused_lstm_gates, _gate_math),
             "convlstm_gates_bwd": (gate_backward_inputs, fused_lstm_gates_bwd, _gate_math_bwd),
             "fused_norm_act": (norm_inputs, fused_batch_norm_leaky_relu,
                                _batch_norm_leaky_relu)}
    errors = dict.fromkeys(KERNELS, 0.0)
    for name, recorded in shapes.items():
        make_args, kernel, plain = cases[name]
        for shape, dtype in sorted(recorded, key=str):
            args = make_args(shape, dtype, gen)
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            errors[name] = max(errors[name], compare(name, shape, dtype, got, want))
    return errors


def time_soak_kernels(shapes: dict, gen) -> dict:
    """K1 and K2 at the soak's bf16 train-step shapes (batch 16), K3 at the
    three largest of its evaluation batch's (bf16, warm and cold); returns
    the device time of one train step's K1 and K2 launches (the three
    ConvLSTMs per dynamics step: two at the state's size, one at half)."""
    dtype, size = torch.bfloat16, 2
    step = {}
    gates = sorted(s for s, d in shapes["convlstm_gates_bwd"] if d == dtype)
    for shape in gates:
        elements = math.prod(shape)
        # lstm0 and lstm2 run at the larger state, lstm1 at the smaller.
        count = (SOAK_FRAMES - 1) * (2 if shape == max(gates, key=math.prod) else 1)
        add_to(step, "convlstm_gates", kernel_time(
            "convlstm_gates", shape, fused_lstm_gates, _gate_math,
            lambda: gate_inputs(shape, dtype, gen), elements * 7 * size,
            elements * GATE_OPS_PER_ELEMENT), count)
        add_to(step, "convlstm_gates_bwd", kernel_time(
            "convlstm_gates_bwd", shape, fused_lstm_gates_bwd, _gate_math_bwd,
            lambda: gate_backward_inputs(shape, dtype, gen), elements * 12 * size,
            elements * GATE_BWD_OPS_PER_ELEMENT), count)
    norms = [s for s, d in shapes["fused_norm_act"] if d == dtype]
    for shape in sorted(norms, key=math.prod, reverse=True)[:3]:
        elements = math.prod(shape)
        kernel_time("fused_norm_act", shape, fused_batch_norm_leaky_relu,
                    _batch_norm_leaky_relu, lambda: norm_inputs(shape, dtype, gen),
                    elements * 2 * size + 16 * shape[1], elements * NORM_OPS_PER_ELEMENT)
    return step


def soak_run(argv: list) -> tuple:
    """``convergence_soak.main(argv)``; its exit code (None for 0) and what
    it printed."""
    printed, code = io.StringIO(), None
    with contextlib.redirect_stdout(printed):
        try:
            convergence_soak.main(argv)
        except SystemExit as exit_info:
            code = exit_info.code
    return code, printed.getvalue()


def convergence_soak_phase(root: str, gen) -> dict:
    """Phase 13: ``tools.convergence_soak`` in bf16 at SOAK_ARGS, run twice
    in one root (stopped at step 50, then resumed to 100): every logged
    loss finite, ``eval_curve.jsonl`` and ``summary.json`` written, the
    second run's first step the first run's last plus one; K1 and K2 3(T-1)
    times per train step and K3 never, K1 3(T-1) and K3 once per frozen
    BatchNorm + LeakyReLU per evaluation batch; K1, K2 and K3 bit for bit
    at every shape the soak gave them.  The accuracy target is not
    required: 100 steps are too few.  Returns the launch counts."""
    soak_root = os.path.join(root, "soak")
    argv = ["--root", soak_root, *SOAK_ARGS]
    with LoopRecorder() as recorder, KernelShapes() as kernel_shapes:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start = time.perf_counter()
        first_code, first = soak_run(argv + ["--stop-at", str(SOAK_FIRST_STOP)])
        first_steps = len(recorder.steps)
        second_code, second = soak_run(argv)
        seconds = time.perf_counter() - start
        torch.cuda.synchronize()
        launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    require(first_code is None and f"[soak] stopped at step {SOAK_FIRST_STOP}" in first,
            (first_code, first[-2000:]))
    require(second_code in (None, 1) and f"[soak] resumed at step {SOAK_FIRST_STOP}" in second,
            (second_code, second[-2000:]))
    steps = [r["step"] for r in recorder.steps]
    require(steps == list(range(1, SOAK_STEPS + 1)) and steps[first_steps] == steps[first_steps - 1] + 1,
            f"soak steps {steps[:3]}...{steps[-3:]}, the second run from {steps[first_steps]}")

    want_step = {"convlstm_gates": 3 * (SOAK_FRAMES - 1),
                 "convlstm_gates_bwd": 3 * (SOAK_FRAMES - 1), "fused_norm_act": 0}
    for record in recorder.steps:
        metrics = record["metrics"]
        require(np.isfinite(metrics["loss"]) and record["launches"] == want_step,
                f"soak step {record['step']}: loss {metrics['loss']}, "
                f"launches {record['launches']}")
    want_batch = {"convlstm_gates": 3 * (SOAK_FRAMES - 1), "convlstm_gates_bwd": 0,
                  "fused_norm_act": len(eval_norm_shapes(SOAK_EVAL_BATCH, SOAK_FRAMES))}
    for forward in recorder.forwards:
        require(forward["frames"] == (SOAK_EVAL_BATCH, SOAK_FRAMES)
                and forward["launches"] == want_batch, f"soak evaluation batch {forward}")
    require([p["label"] for p in recorder.passes] == [None, "one_hot"] * 2
            and all(p["batches"] == SOAK_EVAL_BATCHES for p in recorder.passes),
            recorder.passes)

    with open(os.path.join(soak_root, "train_log.jsonl")) as f:
        logged = [json.loads(line) for line in f if line.strip()]
    losses = [(r["step"], k, v) for r in logged for k, v in r.items() if "loss" in k]
    require(losses and all(np.isfinite(v) for _, _, v in losses),
            [x for x in losses if not np.isfinite(x[2])][:5])
    curve = convergence_soak.read_eval_curve(os.path.join(soak_root, "eval_curve.jsonl"))
    require([r["step"] for r in curve] == [SOAK_FIRST_STOP, SOAK_STEPS] and all(
        np.isfinite(r[k]) for r in curve for k in ("observations_loss", "actions_accuracy",
                                                   "one_hot_actions_accuracy")), curve)
    with open(os.path.join(soak_root, "artifacts", "summary.json")) as f:
        summary = json.load(f)
    require(summary["steps"] == SOAK_STEPS and summary["target_met"] == (second_code is None), summary)

    errors = check_kernels_at(kernel_shapes.shapes, gen)
    kernels_per_step = time_soak_kernels(kernel_shapes.shapes, gen)
    # The first step of each run builds cuDNN's plans; the rest are timed.
    step_ms = [r["seconds"] * 1e3 for r in recorder.steps
               if r["step"] not in (1, SOAK_FIRST_STOP + 1)]
    pass_s = [p["seconds"] for p in recorder.passes]
    emit(phase="convergence_soak", dtype="bf16", steps=SOAK_STEPS, seconds=seconds,
         train_step_ms_median=statistics.median(step_ms), train_step_ms_min=min(step_ms),
         train_step_ms_max=max(step_ms),
         evaluation_ms=[1e3 * (a + b) for a, b in zip(pass_s[::2], pass_s[1::2])],
         evaluation_pass_ms=[1e3 * s for s in pass_s], peak_memory_gib=peak_gib,
         launches=launches, launches_per_step=want_step,
         launches_per_evaluation_batch=want_batch,
         evaluation_batches=len(recorder.forwards), eval_curve=curve,
         best_actions_accuracy=summary["best_actions_accuracy"],
         best_one_hot_actions_accuracy=summary["best_one_hot_actions_accuracy"],
         target_met=summary["target_met"], logged_losses=len(losses),
         kernel_shapes={name: sorted(f"{DTYPE_NAMES[d]} {s}" for s, d in shapes)
                        for name, shapes in kernel_shapes.shapes.items()},
         max_abs_err=errors, kernels_per_step=kernels_per_step)
    return launches


def frcnn_weights() -> dict:
    variables = random_frcnn_variables(FRCNN_WEIGHTS_SEED)
    variables["params"]["box_head"]["cls_score"]["bias"][frcnn.PERSON_LABEL] += (
        FRCNN_PERSON_BIAS)
    return variables


def tennis_frames(count: int) -> np.ndarray:
    """(count, 96, 256, 3) frames in [0, 1]: a player-sized square moving
    over the background."""
    video = make_moving_square_video(count, FRCNN_HEIGHT, FRCNN_WIDTH, square=24,
                                     actions_count=5, seed=SEED, step_pixels=8)
    return np.stack([video.get_frame_at(i) for i in range(count)]).astype(np.float32) / 255.0


def exact_rig(variables: dict) -> dict:
    """tests/test_torch_frcnn.py's exact rig: the proposals are the anchors
    at one score, every valid RoI scores 'person' exactly 1 and keeps its
    box: the outputs depend on no floating-point rounding, only on the
    order of equal scores."""
    variables = copy.deepcopy(variables)
    p = variables["params"]
    for name, value in (("kernel", 0.0), ("bias", 2.0)):
        p["rpn_head"]["cls_logits"][name][:] = value
    for head in (p["rpn_head"]["bbox_pred"], p["box_head"]["bbox_pred"]):
        head["kernel"][:] = 0.0
        head["bias"][:] = 0.0
    p["box_head"]["cls_score"]["kernel"][:] = 0.0
    p["box_head"]["cls_score"]["bias"][:] = -100.0
    p["box_head"]["cls_score"]["bias"][frcnn.PERSON_LABEL] = 0.0
    return variables


def near_a_threshold(class_scores: np.ndarray, detection_scores: np.ndarray) -> bool:
    """Whether one frame's outputs hang on a score within FRCNN_SCORE_ATOL
    of a threshold: a RoI's person score near 0.05 or 0.8, or the last
    detection the top-100 keeps near the first it drops."""
    ranked = np.sort(detection_scores)[::-1]
    cut = frcnn.DETECTIONS_PER_IMG
    return bool(any((np.abs(class_scores - t) <= FRCNN_SCORE_ATOL).any()
                    for t in (frcnn.BOX_SCORE_THRESH, 0.8))
                or (len(ranked) > cut and ranked[cut] > 0
                    and ranked[cut - 1] - ranked[cut] <= FRCNN_SCORE_ATOL))


def detections_agree(card: tuple, cpu: tuple, frame: int) -> bool:
    """One frame's final detections within FRCNN_SCORE_ATOL and
    FRCNN_BOX_ATOL, with the same labels."""
    (boxes, scores, labels), (want_boxes, want_scores, want_labels) = (
        [x[frame] for x in card], [x[frame] for x in cpu])
    return bool(np.array_equal(labels, want_labels)
                and np.abs(scores - want_scores).max() <= FRCNN_SCORE_ATOL
                and np.abs(boxes - want_boxes).max() <= FRCNN_BOX_ATOL)


class NmsCalls:
    """Within the block, a copy of the candidates and threshold of every
    ``nms_masks`` call that the detector module makes (run it eagerly)."""

    def __enter__(self):
        self.calls = []
        self._saved = frcnn.nms_masks
        saved, calls = self._saved, self.calls

        def recorded(candidates, iou_threshold):
            calls.append(([(b.clone(), s.clone()) for b, s in candidates], iou_threshold))
            return saved(candidates, iou_threshold)

        frcnn.nms_masks = recorded
        return self

    def __exit__(self, *exc_info):
        frcnn.nms_masks = self._saved


def nms_groups(calls: list) -> list:
    """The sets of the recorded ``nms_masks`` calls as each stacks them for
    one ``nms_keep``: (boxes, scores, threshold) per set shape, in order."""
    groups = []
    for candidates, threshold in calls:
        shapes = {}
        for boxes, scores in candidates:
            shapes.setdefault(tuple(boxes.shape), []).append((boxes, scores))
        groups += [(torch.stack([b for b, _ in members]), torch.stack([s for _, s in members]),
                    threshold) for members in shapes.values()]
    return groups


def sorted_boxes(boxes: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """A group's boxes in score order, (sets, n, 4), as ``nms_masks`` gives
    them to K4."""
    ordered = frcnn._score_order(boxes, scores)[1]
    return ordered.reshape(-1, ordered.shape[-2], 4)


def nms_path_time(calls: list) -> dict:
    """The detector's NMS on the candidates of one call, per call (the sum
    over its ``nms_masks`` calls), in device ms behind a sleep kernel: the
    whole ``nms_masks``; per set shape the score order (``_score_order``:
    the sort and the gather), K4's mask kernel and its sweep kernel, and
    the passes that the mask kernel replaced (the IoU, the threshold and
    the packing in PyTorch, ``_packed_rows``) with the sweep kernel on
    their rows; and the most memory each path held above what was
    allocated before it."""
    times = dict(whole_ms=sum(device_ms(lambda: frcnn.nms_masks(c, t), launches=5)
                              for c, t in calls),
                 order_ms=0.0, mask_ms=0.0, sweep_ms=0.0, plain_rows_ms=0.0,
                 plain_rows_sweep_ms=0.0)
    groups = nms_groups(calls)
    for boxes, scores, threshold in groups:
        times["order_ms"] += device_ms(lambda: frcnn._score_order(boxes, scores), launches=5)
        ordered = sorted_boxes(boxes, scores)
        times["mask_ms"] += device_ms(lambda: nms_mask_kernel(ordered, threshold), launches=5)
        rows = nms_mask_kernel(ordered, threshold)
        times["sweep_ms"] += device_ms(lambda: nms_sweep_kernel(rows), launches=5)
        times["plain_rows_ms"] += device_ms(lambda: _packed_rows(ordered, threshold),
                                            launches=5)
        rows = plain_rows(ordered, threshold)
        times["plain_rows_sweep_ms"] += device_ms(lambda: nms_sweep_kernel(rows), launches=5)
        del rows
    times["earlier_ms"] = times["order_ms"] + times["plain_rows_ms"] + times["plain_rows_sweep_ms"]

    def peak_mib(path) -> float:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        path()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - before) / 2 ** 20

    times["peak_mib"] = peak_mib(lambda: [frcnn.nms_masks(c, t) for c, t in calls])
    times["earlier_peak_mib"] = peak_mib(lambda: [nms_sweep_kernel(plain_rows(
        sorted_boxes(b, s), t)) for b, s, t in groups])
    emit(phase="nms_path", card=nvidia_smi(),
         groups=[[tuple(b.shape) for b, _ in c] for c, _ in calls], **times)
    return times


def device_activity(call) -> dict:
    """One call of ``call`` under ``torch.profiler``: its kernels (memsets
    among them, copies not), its copies by direction (the profiler of the
    card's PyTorch 2.11 has missed host-to-device copies late in a long
    process: ``host_transfers`` counts them), its device busy ms and its
    five costliest device operations (name, count, ms).  Profile a graph's
    replay only right after its capture: see the profiler crash under
    "Captured train steps" in ROADMAP.md's traps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    copies = {way: sum(e.count for e in events if e.key.startswith(f"Memcpy {way}"))
              for way in ("HtoD", "DtoH", "DtoD")}
    top = sorted(events, key=lambda e: -e.device_time_total)[:5]
    return dict(kernels=sum(e.count for e in events if not e.key.startswith("Memcpy")),
                copies=copies, busy_ms=sum(e.device_time_total for e in events) / 1e3,
                top=[(e.key[:80], e.count, e.device_time_total / 1e3) for e in top])


def require_same_outputs(got, want, what: str) -> None:
    """Numpy outputs (a tuple, a dict or one array) equal bit for bit."""
    def arrays(out):
        if isinstance(out, dict):
            return [out[key] for key in sorted(out)]
        return list(out) if isinstance(out, tuple) else [out]

    got, want = arrays(got), arrays(want)
    require(len(got) == len(want) and all(
        a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
        for a, b in zip(got, want)), f"{what}: graphed and eager differ")


def detector_phase(root: str) -> dict:
    """Phase 14: ``evaluation.detector: frcnn`` through ``make_detector`` on a
    random ``frcnn.npz`` in the converter's layout: the loaded weights are
    the file's bit for bit; 16 tennis-shaped frames at the default transform
    give static, finite outputs with some person boxes above 0.8, the
    detector's forward a replayed graph (6 K4 launches per call, one copy
    in, three out); the same call op by op (``graphs.Eager``) bit for bit,
    both ways timed whole and split (backbone and FPN, box stages) with
    their kernels and copies; K4 bit for bit and timed on the sorted boxes
    the call gave it, and the NMS path per call (``nms_path_time``); the
    person boxes with TF32 on and off (a graph per setting,
    each equal to the eager call); peak memory; then f32 with TF32 off
    against the CPU at a 32/86 transform: the FPN levels within
    backbone_error's tolerance, the final detections within
    FRCNN_SCORE_ATOL and FRCNN_BOX_ATOL in every frame that hangs on no
    score near a threshold (``near_a_threshold``; flips across those are
    counted), and the exact rig's detections bit for bit.  Returns K4's
    launches in the main path's run, its largest error and its times per
    detector call."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()  # nothing captured before this phase's graphs is freed while they live
    directory = os.path.join(root, "frcnn_weights")
    variables = frcnn_weights()
    save_variables_npz(variables, os.path.join(directory, pretrained.WEIGHT_FILES["frcnn"]))
    config = {"evaluation": {"detector": "frcnn"},
              "tpu": {"pretrained_weights_dir": directory}}
    detector = make_detector(config)
    backend = detector.backend
    model = backend.model
    tensors = require_same_weights(model, frcnn.make_frcnn(load_variables_npz(
        os.path.join(directory, pretrained.WEIGHT_FILES["frcnn"])), device="cpu"), "frcnn")
    frames_np = tennis_frames(FRCNN_FRAMES)

    # 1. The main path: make_detector's player centres, the forward a
    # captured graph; K4 counted from 0 around it.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    centers = detector(frames_np[None])
    torch.cuda.synchronize()
    launches = nms_keep.launches
    require(launches == 3 * NMS_LAUNCHES_PER_CALL
            and [p.captures for p in backend.programs.values()] == [1],
            f"the detector launched K4 {launches} times in {len(backend.programs)} programs")
    require(centers.shape == (1, FRCNN_FRAMES, 2) and np.isfinite(centers).all(), centers)

    # 2. The graphed call (one copy in, one replay, three readbacks) and the
    # eager one, bit for bit; profiled right after the graph's capture.
    graphed_ms = synchronised_ms(lambda i: backend.detect(frames_np), FRCNN_TIMED_CALLS, warm=1)
    before = nms_keep.launches
    boxes, scores, labels = graphed = backend.detect(frames_np)
    per_call = nms_keep.launches - before
    graphed_activity = device_activity(lambda: backend.detect(frames_np))
    transfers = host_transfers(lambda: backend.detect(frames_np))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    require(per_call == 3 * NMS_LAUNCHES_PER_CALL and transfers == 1 + 3,
            f"a graphed call: {per_call} K4 launches, {transfers} synchronising transfers")
    eager = frcnn.make_person_box_backend(variables, backend=graphs.Eager)
    eager_ms = synchronised_ms(lambda i: eager.detect(frames_np), FRCNN_TIMED_CALLS, warm=1)
    with NmsCalls() as calls:
        require_same_outputs(graphed, eager.detect(frames_np), "the detector")
    eager_activity = device_activity(lambda: eager.detect(frames_np))
    nms_sets = [(sorted_boxes(b, s), t) for b, s, t in nms_groups(calls.calls)]
    require([(tuple(b.shape[:2]), t) for b, t in nms_sets]
            == [(NMS_SHAPES[0], frcnn.RPN_NMS_THRESH), (NMS_SHAPES[2], frcnn.RPN_NMS_THRESH),
                (NMS_SHAPES[1], frcnn.BOX_NMS_THRESH)],
            f"K4's sets {[(tuple(b.shape), t) for b, t in nms_sets]}")
    require(boxes.shape == (FRCNN_FRAMES, frcnn.DETECTIONS_PER_IMG, 4)
            and scores.shape == labels.shape == (FRCNN_FRAMES, frcnn.DETECTIONS_PER_IMG)
            and np.isfinite(boxes).all() and np.isfinite(scores).all(),
            (boxes.shape, scores.shape))
    person = int((scores > 0.8).sum())
    require(person > 0 and (labels[scores > 0] == frcnn.PERSON_LABEL).all()
            and (labels[scores <= 0] == -1).all(), f"{person} person boxes above 0.8")

    # 3. Split: the backbone and FPN, then the box stages, eagerly and as
    # graphs on static frames and static levels.
    frames = torch.as_tensor(frames_np, device="cuda")
    input_size = frames.shape[1:3]
    backbone_ms, box_ms = [], []
    for _ in range(FRCNN_TIMED_CALLS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        levels = model.features(frames)
        torch.cuda.synchronize()
        middle = time.perf_counter()
        model.detect(levels, input_size)
        torch.cuda.synchronize()
        backbone_ms.append((middle - start) * 1e3 / FRCNN_FRAMES)
        box_ms.append((time.perf_counter() - middle) * 1e3 / FRCNN_FRAMES)
    features = graphs.Program(lambda x: ((), model.features(x)), (), [frames], model,
                              graphs.CudaGraph)
    detect = graphs.Program(lambda *lv: ((), model.detect(lv, input_size)), (), levels, model,
                            graphs.CudaGraph)
    graphed_backbone_ms = [ms / FRCNN_FRAMES for ms in
                           synchronised_ms(lambda i: features(), FRCNN_TIMED_CALLS, warm=1)]
    graphed_box_ms = [ms / FRCNN_FRAMES for ms in
                      synchronised_ms(lambda i: detect(), FRCNN_TIMED_CALLS, warm=1)]
    require_same_outputs(tuple(graphs.to_numpy(t) for t in detect()), graphed,
                         "the graphed box stages")
    del features, detect, levels

    # 4. K4 on the boxes of the call, bit for bit, and its times per call;
    # the NMS path per call, and the passes its mask kernel replaced.
    nms_error = max(check_nms(b, t, "detector") for b, t in nms_sets)
    nms_times, nms_kernels = {}, dict(mask_ms=0.0, sweep_ms=0.0)
    for b, t in nms_sets:
        times = nms_time(b, t)
        add_to(nms_times, "nms_keep", times)
        for key in nms_kernels:
            nms_kernels[key] += times[key]
    nms_path = nms_path_time(calls.calls)
    del nms_sets, calls

    # 5. TF32 off: a graph of its own, equal to the eager call.
    torch.backends.cudnn.allow_tf32 = False
    off = backend.detect(frames_np)
    require_same_outputs(off, eager.detect(frames_np), "the detector with TF32 off")
    require(sorted(key[1:] for key in backend.programs) == [(False, False), (True, False)],
            f"programs {list(backend.programs)}")
    torch.backends.cudnn.allow_tf32 = True
    emit(phase="detector", frames=FRCNN_FRAMES, input=[FRCNN_HEIGHT, FRCNN_WIDTH],
         transform=list(model.geometry(FRCNN_HEIGHT, FRCNN_WIDTH)[1:]), weights_tensors=tensors,
         weights_bit_for_bit=True, graphed_equals_eager=True, nms_launches_per_call=per_call,
         graphed_ms_per_frame=statistics.median(graphed_ms) / FRCNN_FRAMES,
         eager_ms_per_frame=statistics.median(eager_ms) / FRCNN_FRAMES,
         graphed_ms_per_frame_all=[ms / FRCNN_FRAMES for ms in graphed_ms],
         eager_ms_per_frame_all=[ms / FRCNN_FRAMES for ms in eager_ms],
         backbone_ms_per_frame=statistics.median(backbone_ms),
         box_stage_ms_per_frame=statistics.median(box_ms), backbone_ms_all=backbone_ms,
         box_stage_ms_all=box_ms,
         graphed_backbone_ms_per_frame=statistics.median(graphed_backbone_ms),
         graphed_box_stage_ms_per_frame=statistics.median(graphed_box_ms),
         graphed_box_stage_ms_all=graphed_box_ms,
         graphed_kernels_per_frame=graphed_activity["kernels"] / FRCNN_FRAMES,
         eager_kernels_per_frame=eager_activity["kernels"] / FRCNN_FRAMES,
         graphed_host_transfers_per_call=transfers,
         graphed_copies_per_call=graphed_activity["copies"],
         eager_copies_per_call=eager_activity["copies"],
         graphed_busy_ms_per_frame=graphed_activity["busy_ms"] / FRCNN_FRAMES,
         graphed_top_per_call=graphed_activity["top"],
         eager_busy_ms_per_frame=eager_activity["busy_ms"] / FRCNN_FRAMES,
         peak_memory_gib=peak_gib, person_boxes_above_0_8_tf32_on=person,
         person_boxes_above_0_8_tf32_off=int((off[1] > 0.8).sum()),
         detections_above_0_05=int((scores > 0).sum()), player_centers=centers[0].tolist(),
         nms_max_abs_err=nms_error, nms_per_call=nms_times["nms_keep"],
         nms_kernels_per_call=nms_kernels, nms_path_per_call=nms_path, card=nvidia_smi())
    del model, detector, backend, eager, frames

    # f32 with TF32 off, the card against the CPU, at the reduced transform.
    torch.backends.cudnn.allow_tf32 = False
    images = frames_np[:FRCNN_PARITY_FRAMES]
    report = {}
    for name, weights in (("random", variables), ("exact_rig", exact_rig(variables))):
        outputs = {}
        for device in ("cuda", "cpu"):
            model = frcnn.make_frcnn(weights, *FRCNN_PARITY_RESIZE, device=device)
            taps = {}
            levels = model.features(torch.as_tensor(images, device=device))
            result = model.detect(levels, images.shape[1:3], taps)
            outputs[device] = ([l.cpu().numpy() for l in levels],
                               tuple(t.cpu().numpy() for t in result),
                               (taps["masked_class_scores"].cpu().numpy(),
                                taps["detection_scores"].cpu().numpy()))
        (card_levels, card, card_scores), (cpu_levels, cpu, cpu_scores) = (
            outputs["cuda"], outputs["cpu"])
        if name == "exact_rig":
            require(all(np.array_equal(a, b) for a, b in zip(card, cpu))
                    and (card[1] > 0.8).any(), "the exact rig's detections differ")
            report[name] = dict(bit_for_bit=True, detections=int((card[1] > 0).sum()))
            continue
        errors = [backbone_error(a, b, f"P{i + 2}") for i, (a, b) in
                  enumerate(zip(card_levels, cpu_levels))]
        near = [near_a_threshold(scores[0][i], scores[1][i])
                for scores in (card_scores, cpu_scores) for i in range(len(images))]
        near = [a or b for a, b in zip(near[:len(images)], near[len(images):])]
        agree = [detections_agree(card, cpu, i) for i in range(len(images))]
        require(all(a or n for a, n in zip(agree, near)),
                f"detections differ away from the thresholds: agree {agree}, near {near}")
        report[name] = dict(levels=errors, frames_agreeing=sum(agree),
                            threshold_flips=sum(not a for a in agree),
                            frames_with_a_score_near_a_threshold=sum(near),
                            max_score_err=float(np.abs(card[1] - cpu[1]).max()),
                            detections=int((cpu[1] > 0).sum()))
    torch.backends.cudnn.allow_tf32 = True
    emit(phase="detector_parity", dtype="f32", tf32=False, frames=FRCNN_PARITY_FRAMES,
         transform=list(FRCNN_PARITY_RESIZE), score_atol=FRCNN_SCORE_ATOL,
         box_atol=FRCNN_BOX_ATOL, **report)
    return dict(launches=launches, max_abs_err=nms_error, times=nms_times["nms_keep"])


# Phase 15, data-parallel training: BAIR's loop config (``loop_config``)
# with one pretraining and three full-phase steps and an evaluation after
# the fourth (one batch per pass), each run in subprocesses that this
# script starts with torchrun's environment; a resumed run takes one more
# full-phase step.  Two ranks are held against one rank at the dryrun's
# tolerances (``__graft_entry__.dryrun_multichip``) on each phase's first
# step from one state: step 1 (pretraining) from the seeded state, and
# the resumed step from one checkpoint.  Past a step the two sides'
# parameters differ by up to 2 lr where a gradient near 0 took the other
# sign in Adam's first update, and the next step's statistics amplify
# that (1.8 times the dryrun's atol at step 2 in an f32 rehearsal).
DP_OVERRIDES = {("training", "pretraining_steps"): 1, ("training", "max_steps"): 4,
                ("training", "save_freq"): 100, ("evaluation", "eval_freq"): 4,
                ("evaluation", "max_evaluation_batches"): 1}
DP_STEPS, DP_TIMED_STEPS = 4, (2, 3, 4)
DP_TIMEOUT_S = 300
# The BatchNorm statistics, centroids and MI matrix among the state's
# tensors: the dryrun's atol for them is lr, for the parameters 4 lr.
DP_STATISTICS = ("running_mean", "running_var", "centroids", "mi_matrix")


def data_parallel_config(root: str) -> dict:
    config = loop_config(root)
    for (section, key), value in DP_OVERRIDES.items():
        config[section][key] = value
    return config


def state_digest(snapshot: dict) -> str:
    """SHA-256 of every byte of a ``state_snapshot``'s tensors (parameters
    and buffers, Adam's slots, the MI matrix)."""
    digest = hashlib.sha256()
    for name, value in itertools.chain(snapshot["model"].items(), snapshot["adam"].items(),
                                       [("mi_matrix", snapshot["mi_matrix"])]):
        digest.update(str(name).encode())
        digest.update(value.contiguous().reshape(-1).view(torch.uint8).numpy())
    return digest.hexdigest()


def data_parallel_rank(spec_path: str) -> None:
    """One process of phase 15 (``chip_smoke.py --data-parallel-rank
    SPEC``): joins the group that its torchrun environment describes (none
    for the one-process run), drives ``cli.train.train`` on BAIR's loop
    config with in-memory videos, each step deterministic
    (``torch.use_deterministic_algorithms``, so that two runs of one
    global batch can be held bit for bit), and writes what it saw to the
    spec's ``result`` path: per step its launches, seconds, loss, rows and
    state digest; the state after ``dump_steps``; the digest after a
    resume and at the end; its peak memory; and on ranks that share the
    card, the time of one step's collectives replayed on their own."""
    with open(spec_path) as f:
        spec = json.load(f)
    device = mesh.init_distributed(spec["device"], backend=spec["backend"])
    rank = mesh.process_info().rank
    config = data_parallel_config(spec["root"])
    config["tpu"]["model_parallel"] = spec.get("model_parallel", 1)
    datasets = loop_datasets(config)
    dumps, digests, collectives = {}, {}, []
    all_reduce, all_gather = torch.distributed.all_reduce, torch.distributed.all_gather

    def recording_all_reduce(tensor, *args, **kwargs):
        collectives.append(("all_reduce", tensor.numel(), str(tensor.dtype)))
        return all_reduce(tensor, *args, **kwargs)

    def recording_all_gather(tensors, tensor, *args, **kwargs):
        collectives.append(("all_gather", tensor.numel(), str(tensor.dtype)))
        return all_gather(tensors, tensor, *args, **kwargs)

    with LoopRecorder() as recorder:
        recorded_step, load_checkpoint = Trainer.train_step, Trainer.load_checkpoint

        def step(trainer, batch):
            record = trainer.global_step + 1 == DP_STEPS and trainer.distributed
            torch.use_deterministic_algorithms(True)
            if record:
                torch.distributed.all_reduce = recording_all_reduce
                torch.distributed.all_gather = recording_all_gather
            try:
                metrics = recorded_step(trainer, batch)
            finally:
                torch.use_deterministic_algorithms(False)
                torch.distributed.all_reduce, torch.distributed.all_gather = (all_reduce,
                                                                              all_gather)
            snapshot = state_snapshot(trainer)
            recorder.steps[-1].update(rows=len(batch.actions), digest=state_digest(snapshot))
            if trainer.global_step in spec["dump_steps"]:
                dumps[trainer.global_step] = dict(snapshot["model"],
                                                  mi_matrix=snapshot["mi_matrix"])
            return metrics

        def load(trainer, name=None):
            load_checkpoint(trainer, name)
            digests["resumed"] = state_digest(state_snapshot(trainer))

        Trainer.train_step, Trainer.load_checkpoint = step, load
        try:
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            trainer = train(config, max_steps=spec["max_steps"], device=device,
                            datasets=datasets)
            torch.cuda.synchronize()
            launches = read_launches()
        finally:
            Trainer.train_step, Trainer.load_checkpoint = recorded_step, load_checkpoint
    digests["final"] = state_digest(state_snapshot(trainer))
    replay_ms = None
    if collectives and spec["backend"] == "gloo":
        # Every collective of these runs spans the world: a 1 x 2 mesh's
        # model group is the world, a data-parallel run's data group too.
        world = torch.distributed.get_world_size()
        buffers = [(kind, torch.zeros(n, dtype=getattr(torch, dtype.split(".")[1]),
                                      device=device)) for kind, n, dtype in collectives]
        for _ in range(2):  # the second is timed
            mesh.barrier()
            torch.cuda.synchronize()
            start = time.perf_counter()
            for kind, buffer in buffers:
                if kind == "all_reduce":
                    torch.distributed.all_reduce(buffer)
                else:
                    torch.distributed.all_gather(
                        [torch.empty_like(buffer) for _ in range(world)], buffer)
            torch.cuda.synchronize()
            replay_ms = (time.perf_counter() - start) * 1e3
    for step_number, tensors in dumps.items():
        torch.save(tensors, os.path.join(spec["root"], f"state_{step_number}_rank{rank}.pt"))
    result = dict(
        process=list(dataclasses.astuple(mesh.process_info())), launches=launches,
        steps=[{k: r[k] for k in ("step", "seconds", "launches", "rows", "digest")}
               | {"loss": r["metrics"]["loss"], "pretraining": r["metrics"]["pretraining"]}
               for r in recorder.steps],
        evaluation_forwards=[f["launches"] for f in recorder.forwards],
        digests=digests, peak_memory_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30,
        collectives=len(collectives), collective_elements=sum(n for _, n, _ in collectives),
        collective_kinds={kind: sum(1 for k, _, _ in collectives if k == kind)
                          for kind in ("all_reduce", "all_gather")},
        collective_replay_ms=replay_ms, sharded=list(layers.sharded_layers(trainer.model)),
        parameter_bytes=sum(p.numel() * p.element_size() for p in trainer.model.parameters()))
    with open(spec["result"] % rank, "w") as f:
        json.dump(result, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class RankGroup:
    """One run of ``data_parallel_rank``: ``world`` processes with
    torchrun's environment (none when ``world`` is 0, the one-process
    trainer), their output in a log beside the run's root."""

    def __init__(self, root: str, name: str, world: int, device: str, backend, **spec):
        self.root, self.name, self.world = os.path.join(root, name), name, world
        os.makedirs(self.root, exist_ok=True)
        spec = dict(spec, root=self.root, device=device, backend=backend,
                    result=os.path.join(self.root, "result_%d.json"))
        spec_path = os.path.join(self.root, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        if world:
            env.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                       WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
        self.logs, self.procs = [], []
        for rank in range(max(world, 1)):
            if world:
                env.update(RANK=str(rank), LOCAL_RANK=str(rank))
            log = open(os.path.join(self.root, f"log_{rank}.txt"), "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--data-parallel-rank", spec_path],
                env=dict(env), stdout=log, stderr=subprocess.STDOUT))

    def stop(self) -> None:
        """Kills the processes still running and closes the logs."""
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in self.logs:
            log.close()

    def wait(self) -> list:
        """Each process's result; raises with the logs' ends if one failed
        or ran past DP_TIMEOUT_S."""
        deadline = time.monotonic() + DP_TIMEOUT_S
        try:
            for proc in self.procs:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            self.stop()
        if any(proc.returncode for proc in self.procs):
            tails = [Path(log.name).read_text()[-3000:] for log in self.logs]
            raise RuntimeError(f"run {self.name} failed (exit codes "
                               f"{[p.returncode for p in self.procs]}):\n" + "\n".join(tails))
        results = []
        for rank in range(max(self.world, 1)):
            with open(os.path.join(self.root, f"result_{rank}.json")) as f:
                results.append(json.load(f))
        return results


def wait_all(*groups: RankGroup) -> list:
    """Each group's results; whatever fails, no process is left running."""
    try:
        return [group.wait() for group in groups]
    finally:
        for group in groups:
            group.stop()


def compare_with_one_rank(two: RankGroup, one: RankGroup, step: int, lr: float,
                          required: bool = True) -> dict:
    """Two ranks' state against one rank's after ``step``, at the dryrun's
    tolerances: parameters rtol 2e-3 and atol 4 lr, BatchNorm statistics,
    centroids and the MI matrix rtol 2e-3 and atol lr (unless not
    ``required``); returns the largest error as a share of its tolerance,
    per kind."""
    got = torch.load(os.path.join(two.root, f"state_{step}_rank0.pt"))
    want = torch.load(os.path.join(one.root, f"state_{step}_rank0.pt"))
    require(got.keys() == want.keys(), "the dumped states differ in their tensors")
    worst = {"parameters": 0.0, "statistics": 0.0}
    for key, value in want.items():
        kind = "statistics" if key.endswith(DP_STATISTICS) else "parameters"
        atol = lr if kind == "statistics" else 4 * lr
        share = float(((got[key].double() - value.double()).abs()
                       / (atol + 2e-3 * value.double().abs())).max())
        require(share <= 1.0 or not required,
                f"step {step}: {key} differs from one rank by {share:.3f} of the dryrun's "
                f"tolerance")
        worst[kind] = max(worst[kind], share)
    return worst


def require_loss_close(two: dict, one: dict) -> None:
    loss, want = two["loss"], one["loss"]
    require(abs(loss - want) < 1e-3 * max(1.0, abs(want)),
            f"step {two['step']}: loss {loss} on two ranks, {want} on one")


def data_parallel_phase(root: str) -> dict:
    """Phase 15: (a) the one-process trainer and one NCCL rank, side by
    side: every step's state and the final state bit for bit; (b) two gloo
    ranks sharing the card, 4 rows each: bit for bit with each other after
    every step, against (a) at the dryrun's tolerances after step 1 (the
    loss within 1e-3 relative), K1 and K2 18 times per rank per step, K3
    never, rank 0 alone evaluating; (c) (b)'s checkpoint resumed on one
    NCCL rank, and (a)'s on two gloo ranks and on the one-process trainer:
    the state bit for bit, the next step's loss finite, and that full-phase
    step on two ranks against the one-process trainer's at the dryrun's
    tolerances.  Prints ms per step per rank, the gloo all-reduce's share
    of a step and peak memory per rank.  Returns the phase's launches, and
    the runs that phase 16 compares with: (a)'s two runs and (c)'s
    one-process resume, by name, with (a)'s NCCL result."""
    start = time.perf_counter()
    # The ranks need the card's memory that earlier phases left cached.
    gc.collect()
    torch.cuda.empty_cache()
    lr = BAIR_CONFIG["training"]["learning_rate"]
    plain = RankGroup(root, "plain", 0, "cuda", None, max_steps=DP_STEPS, dump_steps=[1, 2])
    nccl = RankGroup(root, "nccl", 1, "cuda", "nccl", max_steps=DP_STEPS, dump_steps=[1])
    (plain_result,), (nccl_result,) = wait_all(plain, nccl)
    gloo = RankGroup(root, "gloo", 2, "cuda:0", "gloo", max_steps=DP_STEPS, dump_steps=[1])
    (gloo_results,) = wait_all(gloo)

    want_step = {"convlstm_gates": 3 * (LOOP_FRAMES - 1),
                 "convlstm_gates_bwd": 3 * (LOOP_FRAMES - 1), "fused_norm_act": 0}
    for result, rows in ((plain_result, LOOP_BATCH), (nccl_result, LOOP_BATCH),
                         *((r, LOOP_BATCH // 2) for r in gloo_results)):
        require([s["step"] for s in result["steps"]] == list(range(1, DP_STEPS + 1)),
                result["steps"])
        for s in result["steps"]:
            require(s["launches"] == want_step and s["rows"] == rows and np.isfinite(s["loss"])
                    and s["pretraining"] == float(s["step"] == 1), s)
    require(nccl_result["process"] == [0, 1, 0, 1] and
            [r["process"] for r in gloo_results] == [[0, 2, 0, 2], [1, 2, 1, 2]],
            (nccl_result["process"], [r["process"] for r in gloo_results]))
    # (a) One NCCL rank: the collectives are identities.
    for got, want in zip(nccl_result["steps"], plain_result["steps"]):
        require(got["digest"] == want["digest"] and got["loss"] == want["loss"],
                f"one NCCL rank differs from the one-process trainer at step {got['step']}")
    require(nccl_result["digests"]["final"] == plain_result["digests"]["final"],
            "one NCCL rank's final state differs from the one-process trainer's")
    emit(phase="data_parallel_one_rank", backend="nccl", steps=DP_STEPS, bit_exact=True,
         losses=[s["loss"] for s in nccl_result["steps"]],
         peak_memory_gib=nccl_result["peak_memory_gib"])
    # (b) Two gloo ranks on the one card.
    for s0, s1 in zip(*(r["steps"] for r in gloo_results)):
        require(s0["digest"] == s1["digest"] and s0["loss"] == s1["loss"],
                f"the two ranks' states differ after step {s0['step']}")
    require(gloo_results[0]["digests"]["final"] == gloo_results[1]["digests"]["final"],
            "the two ranks' final states differ")
    require_loss_close(gloo_results[0]["steps"][0], nccl_result["steps"][0])
    pretraining_share = compare_with_one_rank(gloo, nccl, 1, lr)
    require(len(gloo_results[0]["evaluation_forwards"]) == 3
            and not gloo_results[1]["evaluation_forwards"],
            "rank 0 alone must evaluate (3 passes of 1 batch)")
    step_ms = [[s["seconds"] * 1e3 for s in r["steps"] if s["step"] in DP_TIMED_STEPS]
               for r in gloo_results]
    median_ms = [statistics.median(ms) for ms in step_ms]
    card = nvidia_smi()
    emit(phase="data_parallel_two_ranks", backend="gloo", shared_card=True,
         rows_per_rank=LOOP_BATCH // 2, frames=LOOP_FRAMES, bit_exact_between_ranks=True,
         step1_loss=gloo_results[0]["steps"][0]["loss"],
         step1_loss_one_rank=nccl_result["steps"][0]["loss"],
         step1_share_of_dryrun_tolerance=pretraining_share, launches_per_rank_step=want_step,
         ms_per_step_median=median_ms, ms_per_step_range=[[min(ms), max(ms)] for ms in step_ms],
         collectives_per_step=gloo_results[0]["collectives"],
         collective_elements_per_step=gloo_results[0]["collective_elements"],
         allreduce_replay_ms=[r["collective_replay_ms"] for r in gloo_results],
         allreduce_share_of_step=[r["collective_replay_ms"] / ms
                                  for r, ms in zip(gloo_results, median_ms)],
         peak_memory_gib=[r["peak_memory_gib"] for r in gloo_results],
         one_rank_peak_memory_gib=nccl_result["peak_memory_gib"], nvidia_smi=card)

    # (c) Elastic resume: two ranks' checkpoint on one rank, one rank's on
    # two and on the one-process trainer.
    resume_step = DP_STEPS + 1
    runs = (("resume_on_one", gloo, 1, "cuda", "nccl"),
            ("resume_on_two", nccl, 2, "cuda:0", "gloo"),
            ("resume_plain", nccl, 0, "cuda", None))
    for name, source, *_ in runs:
        shutil.copytree(os.path.join(source.root, "checkpoints"),
                        os.path.join(root, name, "checkpoints"))
    groups = {name: RankGroup(root, name, world, device, backend, max_steps=resume_step,
                              dump_steps=[resume_step])
              for name, _, world, device, backend in runs}
    resumed = dict(zip(groups, wait_all(*groups.values())))
    for name, source_result in (("resume_on_one", gloo_results[0]),
                                ("resume_on_two", nccl_result), ("resume_plain", nccl_result)):
        for result in resumed[name]:
            require(result["digests"]["resumed"] == source_result["digests"]["final"],
                    f"{name}: the resumed state differs from the saved one")
            require([s["step"] for s in result["steps"]] == [resume_step]
                    and np.isfinite(result["steps"][0]["loss"]), (name, result["steps"]))
        require(len({r["digests"]["final"] for r in resumed[name]}) == 1,
                f"{name}: the ranks' states differ after the resumed step")
    require_loss_close(resumed["resume_on_two"][0]["steps"][0],
                       resumed["resume_plain"][0]["steps"][0])
    full_share = compare_with_one_rank(groups["resume_on_two"], groups["resume_plain"],
                                       resume_step, lr)
    emit(phase="data_parallel_resume", bit_exact=True,
         two_to_one_loss=resumed["resume_on_one"][0]["steps"][0]["loss"],
         one_to_two_loss=resumed["resume_on_two"][0]["steps"][0]["loss"],
         one_process_loss=resumed["resume_plain"][0]["steps"][0]["loss"],
         full_step_share_of_dryrun_tolerance=full_share)

    launches = dict.fromkeys(want_step, 0)
    for result in (plain_result, nccl_result, *gloo_results,
                   *itertools.chain.from_iterable(resumed.values())):
        for name, count in result["launches"].items():
            launches[name] += count
    emit(phase="data_parallel", seconds=time.perf_counter() - start, launches=launches,
         nvidia_smi=card)
    return launches, dict(plain=plain, nccl=nccl, nccl_result=nccl_result,
                          resume_plain=groups["resume_plain"],
                          resume_plain_result=resumed["resume_plain"][0])


# Phase 16, tensor-parallel training: phase 15's loop config with
# tpu.model_parallel 2 (tp_min_channels at its default, 256) on two gloo
# ranks that share the card as a 1 x 2 mesh.  The ranks are held against
# phase 15's one-process runs on each phase's first step from one state:
# step 1 from the seeded state, and a full-phase step resumed from one
# checkpoint (phase 15's NCCL rank's), as phase 15 holds its two ranks.
# After step 2 the state is compared too, and its share of the dryrun's
# tolerance printed, not required: past a step the two sides' parameters
# differ by up to 2 lr where Adam's first update took the other sign.
TP_MODEL_PARALLEL = 2


def tensor_parallel_phase(root: str, phase15: dict) -> dict:
    """Phase 16: (a) two gloo ranks sharing the card as a 1 x 2 mesh, 8
    rows each: the sharded layers the same on both ranks, each rank's
    state (sharded tensors gathered) bit for bit with the other's after
    every step, against phase 15's one-process trainer at the dryrun's
    tolerances after step 1 (the loss within 1e-3 relative), K1 and K2 18
    times per rank per step, K3 never, rank 0 alone evaluating (on its
    full-width copy); (b) phase 15's NCCL checkpoint resumed on the mesh:
    the state bit for bit, the next full-phase step finite and within the
    dryrun's tolerances of phase 15's one-process step from that
    checkpoint.  Prints the sharded layers and the parameter bytes per
    rank, ms per step per rank, one step's collectives replayed alone and
    their share of the step, and peak memory per rank.  Returns the
    phase's launches."""
    start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    lr = BAIR_CONFIG["training"]["learning_rate"]
    tp = RankGroup(root, "tensor_parallel", 2, "cuda:0", "gloo", max_steps=DP_STEPS,
                   dump_steps=[1, 2], model_parallel=TP_MODEL_PARALLEL)
    (results,) = wait_all(tp)
    want_step = {"convlstm_gates": 3 * (LOOP_FRAMES - 1),
                 "convlstm_gates_bwd": 3 * (LOOP_FRAMES - 1), "fused_norm_act": 0}
    require([r["process"] for r in results] == [[0, 2, 0, 2], [1, 2, 1, 2]],
            [r["process"] for r in results])
    sharded = results[0]["sharded"]
    require(sharded and results[1]["sharded"] == sharded, "the ranks shard different layers")
    for result in results:
        require([s["step"] for s in result["steps"]] == list(range(1, DP_STEPS + 1)),
                result["steps"])
        for s in result["steps"]:
            require(s["launches"] == want_step and s["rows"] == LOOP_BATCH
                    and np.isfinite(s["loss"]) and s["pretraining"] == float(s["step"] == 1), s)
    for s0, s1 in zip(*(r["steps"] for r in results)):
        require(s0["digest"] == s1["digest"] and s0["loss"] == s1["loss"],
                f"the model group's states differ after step {s0['step']}")
    require(results[0]["digests"]["final"] == results[1]["digests"]["final"],
            "the model group's final states differ")
    require(len(results[0]["evaluation_forwards"]) == 3
            and not results[1]["evaluation_forwards"],
            "rank 0 alone must evaluate (3 passes of 1 batch)")
    plain = phase15["plain"]
    require_loss_close(results[0]["steps"][0], phase15["nccl_result"]["steps"][0])
    pretraining_share = compare_with_one_rank(tp, plain, 1, lr)
    step2_share = compare_with_one_rank(tp, plain, 2, lr, required=False)
    step_ms = [[s["seconds"] * 1e3 for s in r["steps"] if s["step"] in DP_TIMED_STEPS]
               for r in results]
    median_ms = [statistics.median(ms) for ms in step_ms]
    card = nvidia_smi()
    emit(phase="tensor_parallel_mesh", backend="gloo", shared_card=True, mesh=[1, 2],
         rows_per_rank=LOOP_BATCH, frames=LOOP_FRAMES, sharded=sharded,
         parameter_bytes_per_rank=[r["parameter_bytes"] for r in results],
         bit_exact_between_ranks=True, step1_loss=results[0]["steps"][0]["loss"],
         step1_loss_one_process=phase15["nccl_result"]["steps"][0]["loss"],
         step1_share_of_dryrun_tolerance=pretraining_share,
         step2_share_of_dryrun_tolerance=step2_share, launches_per_rank_step=want_step,
         ms_per_step_median=median_ms, ms_per_step_range=[[min(ms), max(ms)] for ms in step_ms],
         collectives_per_step=results[0]["collectives"],
         collective_kinds_per_step=results[0]["collective_kinds"],
         collective_elements_per_step=results[0]["collective_elements"],
         collective_replay_ms=[r["collective_replay_ms"] for r in results],
         collective_share_of_step=[r["collective_replay_ms"] / ms
                                   for r, ms in zip(results, median_ms)],
         peak_memory_gib=[r["peak_memory_gib"] for r in results], nvidia_smi=card)

    # (b) Phase 15's NCCL checkpoint on the mesh, one more full-phase step.
    resume_step = DP_STEPS + 1
    shutil.copytree(os.path.join(phase15["nccl"].root, "checkpoints"),
                    os.path.join(root, "tensor_parallel_resume", "checkpoints"))
    resume = RankGroup(root, "tensor_parallel_resume", 2, "cuda:0", "gloo",
                       max_steps=resume_step, dump_steps=[resume_step],
                       model_parallel=TP_MODEL_PARALLEL)
    (resumed,) = wait_all(resume)
    for result in resumed:
        require(result["digests"]["resumed"] == phase15["nccl_result"]["digests"]["final"],
                "the mesh's resumed state differs from phase 15's checkpoint")
        require([s["step"] for s in result["steps"]] == [resume_step]
                and np.isfinite(result["steps"][0]["loss"]), result["steps"])
    require(resumed[0]["digests"]["final"] == resumed[1]["digests"]["final"],
            "the model group's states differ after the resumed step")
    require_loss_close(resumed[0]["steps"][0], phase15["resume_plain_result"]["steps"][0])
    full_share = compare_with_one_rank(resume, phase15["resume_plain"], resume_step, lr)
    launches = dict.fromkeys(want_step, 0)
    for result in (*results, *resumed):
        for name, count in result["launches"].items():
            launches[name] += count
    emit(phase="tensor_parallel_resume", bit_exact=True,
         loss=resumed[0]["steps"][0]["loss"], full_step_share_of_dryrun_tolerance=full_share)
    emit(phase="tensor_parallel", seconds=time.perf_counter() - start, launches=launches,
         nvidia_smi=card)
    return launches


# Phase 17, the tools: profile_step at its defaults (the JAX tool's: batch
# 8, 12 frames, 256x256) but one profiled step, not 3, since a step's trace
# is 80 MB of JSON (3 steps: 242 MB, 915 160 events, captured in 34 s and
# parsed in 9 s on an H100 machine); bench_input_pipeline at BAIR's loader
# shape over 4 flat videos of 48 frames (4 x 42 samples, 21 batches of 8
# per epoch); gpu_soak's five stages.
PROFILE_STEPS = 1
# The by-group and by-scope totals against the profiler's own kernel sum.
PROFILE_TOTAL_RTOL = 0.01
PIPELINE_VIDEOS, PIPELINE_LENGTH, PIPELINE_MIN_BATCHES = 4, 48, 20
TOOL_TIMEOUT_S = 600
# The one required family of gpu_soak's validation that the card's machine
# cannot compute: the SVM action classification needs scikit-learn, which
# is not installed there.  Without it the tool exits 1 with this family
# missing and its marker written; the phase requires those to be the only
# failures and checks every other family itself.
SOAK_EXEMPT_FAMILY, SOAK_EXEMPT_PACKAGE = "action_classification/linear/accuracy", "sklearn"


def profile_tool(root: str) -> dict:
    """Phase 17a: ``tools.profile_step`` on the bf16 flagship trainer at its
    defaults but PROFILE_STEPS: K1 66 and K2 33 per profiled step in the
    trace, and as many per step at the wrappers' counts (the warm step
    included); the by-group and by-scope totals within 1 % of
    ``key_averages()``'s CUDA time.  Returns the launch counts."""
    trace_dir = os.path.join(root, "profile_trace")
    steps = PROFILE_STEPS + 1  # the warm step and the profiled ones
    expected = {"convlstm_gates": 6 * DYNAMICS_STEPS * steps,
                "convlstm_gates_bwd": 3 * DYNAMICS_STEPS * steps, "fused_norm_act": 0}
    reset_launches()
    t0 = time.perf_counter()
    prof = profile_step.capture(LOOP_BATCH, PROFILE_STEPS, 256, 256, TRAIN_FRAMES, trace_dir)
    capture_s = time.perf_counter() - t0
    launches = read_launches()
    require(launches == expected, f"the profiled trainer launched {launches}")
    # The ranges' projections on the device's timeline are CUDA events too.
    kernel_us = sum(e.device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation)
    del prof
    gc.collect()
    result = profile_step.analyze(profile_step.find_trace(trace_dir))
    require(result["time_key"] == "device_us" and result["steps"] == PROFILE_STEPS,
            (result["time_key"], result["steps"]))

    def per_step(fragment):
        return sum(r["calls"] for r in result["rows"] if fragment in r["name"]) / PROFILE_STEPS

    gates = {"convlstm_gates": per_step("gates_fwd_kernel"),
             "convlstm_gates_bwd": per_step("gates_bwd_kernel")}
    require(gates == {"convlstm_gates": 6 * DYNAMICS_STEPS,
                      "convlstm_gates_bwd": 3 * DYNAMICS_STEPS}, f"per profiled step: {gates}")
    # K2 runs only in the backward pass: its scope comes through its forward
    # op's sequence number.
    gate_scopes = {(r["name"][:60], r["scope"]) for r in result["rows"]
                   if "gates_fwd_kernel" in r["name"] or "gates_bwd_kernel" in r["name"]}
    require({scope for _, scope in gate_scopes} == {"dynamics (convlstm hourglass)"},
            f"the gate kernels' scopes: {sorted(gate_scopes)}")
    totals = {table: sum(result[table].values()) for table in ("by_category", "by_scope")}
    for table, us in totals.items():
        require(abs(us - kernel_us) <= PROFILE_TOTAL_RTOL * kernel_us,
                f"{table} sums to {us} us against the profiler's {kernel_us}")

    def per_step_ms(table):
        return {k: us / 1e3 / PROFILE_STEPS for k, us in result[table].items()}

    emit(phase="profile_step", batch=LOOP_BATCH, frames=TRAIN_FRAMES, steps=PROFILE_STEPS,
         capture_s=capture_s, trace=result["trace"],
         kernel_ms_per_step=kernel_us / 1e3 / PROFILE_STEPS, table_totals_us=totals,
         gate_launches_per_step=gates, by_group_ms_per_step=per_step_ms("by_category"),
         by_scope_ms_per_step=per_step_ms("by_scope"),
         unattributed_share=result["unattributed_share"],
         unattributed_top=[dict(kernel=r["name"][:90], ms_per_step=r["device_us"] / 1e3
                                / PROFILE_STEPS) for r in result["unattributed_top"][:5]],
         top=[dict(kernel=r["name"][:90], scope=r["scope"], group=r["group"],
                   ms_per_step=r["device_us"] / 1e3 / PROFILE_STEPS,
                   calls_per_step=r["calls_per_step"]) for r in result["rows"][:10]])
    return launches


def pipeline_tool(loop_step_ms: float) -> None:
    """Phase 17b: ``tools.bench_input_pipeline`` as its own process at BAIR's
    loader shape (256x256, batch 8, 7 frames), at least 20 timed batches per
    worker mode, beside phase 10's loop step period."""
    batches = PIPELINE_VIDEOS * (PIPELINE_LENGTH - LOOP_FRAMES + 1) // LOOP_BATCH
    require(batches >= PIPELINE_MIN_BATCHES, batches)
    argv = ["--size", "256", "--batch-size", str(LOOP_BATCH), "--observations",
            str(LOOP_FRAMES), "--videos", str(PIPELINE_VIDEOS), "--length", str(PIPELINE_LENGTH)]
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "playablevideogeneration_tpu_torch.tools.bench_input_pipeline",
         *argv], capture_output=True, text=True, check=True, timeout=TOOL_TIMEOUT_S).stdout
    seconds = time.perf_counter() - t0
    result = json.loads(out.strip().splitlines()[-1])
    modes = {mode: dict(result[mode], batch_ms=1e3 / result[mode]["batches_per_sec"])
             for mode in ("thread", "process")}
    require(all(m["frames_per_sec"] > 0 for m in modes.values()), modes)
    emit(phase="bench_input_pipeline", argv=argv, timed_batches_per_mode=batches,
         workers=result["workers"], **modes, batch_bytes=LOOP_BATCH * LOOP_FRAMES * 256 * 256
         * 3 * 4, loop_step_ms=loop_step_ms,
         loop_frames_per_sec=LOOP_BATCH * LOOP_FRAMES / (loop_step_ms / 1e3), seconds=seconds)


def soak_tool(root: str) -> None:
    """Phase 17c: ``tools.gpu_soak`` as its own process: all five stages
    ran (each exits the tool with 1 when it fails) and the tool's
    validation passed, but for SOAK_EXEMPT_FAMILY where SOAK_EXEMPT_PACKAGE
    is not installed; every other required family is finite in
    ``data.yml``."""
    import yaml

    soak_root = os.path.join(root, "gpu_soak")
    exempt = importlib.util.find_spec(SOAK_EXEMPT_PACKAGE) is None
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "playablevideogeneration_tpu_torch.tools.gpu_soak", "--root",
         soak_root], capture_output=True, text=True, timeout=TOOL_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    summaries = [line[len("[gpu_soak] "):] for line in proc.stdout.splitlines()
                 if line.startswith("[gpu_soak] {")]
    require(len(summaries) == 1, proc.stdout[-3000:] + proc.stderr[-5000:])
    summary = json.loads(summaries[0])
    require(list(summary["stage_seconds"]) == list(gpu_soak.STAGES), summary)
    marker = SOAK_EXEMPT_FAMILY.split("/")[0] + "_unavailable"
    want = {"missing_families": [SOAK_EXEMPT_FAMILY] * exempt,
            "unavailable_markers": [marker] * exempt, "nonfinite": []}
    require(proc.returncode == int(exempt)
            and {k: summary[k] for k in want} == want, (proc.returncode, summary))
    with open(os.path.join(soak_root, "out/evaluation_results/synthetic/data.yml")) as f:
        metrics = yaml.safe_load(f)
    for family in gpu_soak.REQUIRED:
        if family != SOAK_EXEMPT_FAMILY or not exempt:
            require(isinstance(metrics.get(family), float) and math.isfinite(metrics[family]),
                    f"gpu_soak's {family}: {metrics.get(family)}")
    emit(phase="gpu_soak", seconds=seconds, returncode=proc.returncode,
         exempted={SOAK_EXEMPT_FAMILY: f"{SOAK_EXEMPT_PACKAGE} not installed"} if exempt
         else {}, **summary)


def tools_phase(root: str, loop_step_ms: float) -> dict:
    """Phase 17: the step profiler, the input-pipeline bench and the CLI
    soak (``tools.gpu_soak``: train, resume, play, build and evaluate, each
    ``python -m`` on the card from its YAML file, every backbone on random
    weight files found through ``PVG_PRETRAINED_WEIGHTS``; every stage's
    exit code 0 and the metrics validated).  Returns the launch counts of
    this process (the soak's stages are processes of their own)."""
    start = time.perf_counter()
    launches = profile_tool(root)
    pipeline_tool(loop_step_ms)
    soak_tool(root)
    emit(phase="tools", seconds=time.perf_counter() - start, launches=launches)
    return launches


# Phase 18, the graphed routes on the bf16 flagship at BAIR's full width:
# the play session against EagerPlay from one state, noise off and on
# (GRAPHED_STEPS steps, a uint8 step, an interpolation step, a rollout of
# ROLLOUT_FRAMES), a weight load mid-session; the builder over 2 batches of
# 8 x 30 and a ragged one of GRAPHED_RAGGED, graphed against eager.
GRAPHED_STEPS = 3
GRAPHED_RAGGED = 4
# Test videos of TEST_VIDEO_FRAMES give two 30-frame sequences each.
GRAPHED_TEST_VIDEOS = (BUILDER_BATCHES * LOOP_BATCH + GRAPHED_RAGGED) // 2


def require_equal(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    require(got.shape == want.shape and np.array_equal(got, want),
            f"{what}: the graphed route differs from the eager one "
            f"({got.shape} vs {want.shape}, max |d| "
            f"{np.abs(got.astype(np.float64) - want).max() if got.shape == want.shape else None})")


def graphed_play(model, obs: np.ndarray, actions: np.ndarray, noise: bool,
                 reload_state=None) -> dict:
    """Phase 18a: a graphed session against EagerPlay bit for bit; the
    session's launches (3 K1 and 15 K3 per step under replay) and its
    rollout's synchronisations (one); with ``reload_state``, those weights
    loaded in place mid-session and the next step against EagerPlay."""
    eager = EagerPlay(model, obs, noise=noise)
    want = [eager.step(int(a)).float().cpu().numpy() for a in actions[:GRAPHED_STEPS]]
    want.append(to_uint8(eager.step(int(actions[GRAPHED_STEPS]))).cpu().numpy())
    want.append(eager.interpolation(0, 3, 0.7).float().cpu().numpy())
    want_rollout = eager.rollout(actions[:ROLLOUT_FRAMES])

    session = PlaySession(model, noise=noise, seed=SEED)
    reset_launches()
    session.start(obs)
    got = [session.generate_next(int(a)) for a in actions[:GRAPHED_STEPS]]
    got.append(session.generate_next_u8(int(actions[GRAPHED_STEPS])))
    got.append(session.generate_next_interpolation(0, 3, 0.7))
    with counted_syncs() as syncs:
        rollout = session.rollout(actions[:ROLLOUT_FRAMES])
    launches = read_launches()
    steps = GRAPHED_STEPS + 2 + ROLLOUT_FRAMES
    require(launches == per_frame_launches(steps), f"{steps} graphed steps launched {launches}")
    require(len(syncs) == 1, f"the graphed rollout synchronised {len(syncs)} times: {syncs}")
    for i, (g, w) in enumerate(zip(got, want)):
        require_equal(g, w, f"step {i}")
    require_equal(rollout, want_rollout, "the rollout")
    require(rollout.std() > 0, "constant rollout")
    record = dict(noise=noise, steps=steps, launches=launches, rollout_syncs=len(syncs),
                  bit_exact=True)

    # A frame handed out with block=False is a copy that later steps leave.
    frame = session.generate_next_u8(1, block=False)
    eager.step(1)
    kept = frame.cpu().numpy()
    for a in (2, 3):
        session.generate_next_u8(a)
        eager.step(a)
    require_equal(frame.cpu().numpy(), kept, "a block=False frame after two steps")

    if reload_state is not None:
        step = session._programs["step"]
        captures = step.captures
        model.load_state_dict(reload_state)
        require_equal(session.generate_next(4), eager.step(4).float().cpu().numpy(),
                      "the step after a weight load")
        require(step.captures == captures + 1, "the weight load was not seen")
        record["reload_seen"] = True
    emit(phase="graphed_play", **record)
    return launches


class EagerBuilder(EvaluationDatasetBuilder):
    """The builder with its forward run op by op, as it ran before its
    forwards became graph replays."""

    def _forward(self, observations, actions, generator):
        return self._eager_forward(observations, actions, generator)


def timed_build(builder) -> tuple:
    """(videos, seconds, peak GiB, launches of each batch's forward)."""
    forwards, forward = [], builder._forward

    def recorded_forward(*args):
        before = read_launches()
        out = forward(*args)
        forwards.append(launches_since(before))
        return out

    builder._forward = recorded_forward
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    videos = builder.build_videos()
    seconds = time.perf_counter() - start
    del builder._forward
    return videos, seconds, torch.cuda.max_memory_allocated() / 2 ** 30, forwards


def require_same_videos(got: list, want: list) -> None:
    require(len(got) == len(want), (len(got), len(want)))
    for index, (g, w) in enumerate(zip(got, want)):
        for i in range(w.get_frames_count()):
            require_equal(g.get_frame_at(i), w.get_frame_at(i), f"video {index} frame {i}")
        require(g.metadata == w.metadata, f"video {index}'s metadata differs")


def graphed_builder(config: dict, model) -> dict:
    """Phase 18b: the builder graphed (twice: capture, then replays only)
    against eager over 2 batches of 8 x 30 and a ragged batch, bit for
    bit, frames and metadata (``inferred_action``, ``encoded_action``);
    87 K1 and 446 K3 per batch under replay; seconds per batch both ways,
    peak memory with the graph pools."""
    width, height = config["model"]["representation_network"]["target_input_size"]
    videos = [make_moving_square_video(TEST_VIDEO_FRAMES, height, width, square=height // 8,
                                       actions_count=config["data"]["actions_count"],
                                       seed=SEED + 200 + i, step_pixels=height // 20)
              for i in range(GRAPHED_TEST_VIDEOS)]
    test = VideoDataset.from_videos(videos, config["evaluation"]["batching"],
                                    get_final_transforms(config)["test"])
    batches = -(-len(test) // LOOP_BATCH)
    require(len(test) == BUILDER_BATCHES * LOOP_BATCH + GRAPHED_RAGGED, len(test))
    eager_videos, eager_s, eager_gib, _ = timed_build(
        EagerBuilder(config, model, test, Logger()))
    builder = EvaluationDatasetBuilder(config, model, test, Logger())
    reset_launches()
    first, first_s, first_gib, forwards = timed_build(builder)
    want = {"convlstm_gates": EVAL_GATE_LAUNCHES, "convlstm_gates_bwd": 0,
            "fused_norm_act": len(EVAL_NORM_SHAPES)}
    require(len(forwards) == batches and all(f == want for f in forwards),
            f"graphed builder batches launched {forwards}")
    launches = read_launches()
    again, again_s, again_gib, _ = timed_build(builder)
    captures = {str(key): p.captures for key, p in builder._programs.items()}
    require(sorted(builder._programs) == [(GRAPHED_RAGGED, EVAL_FRAMES),
                                          (LOOP_BATCH, EVAL_FRAMES)]
            and set(captures.values()) == {1}, f"the builder's programs: {captures}")
    require_same_videos(first, eager_videos)
    require_same_videos(again, eager_videos)
    # One full batch's forward under the profiler, both ways.
    batch = collate([test[i] for i in range(LOOP_BATCH)])
    observations = sequence_to_nchw(batch.observations, "cuda")
    actions = torch.as_tensor(batch.actions, device="cuda")
    batch_forward = {}
    for way, forward in (("graphed", builder._forward), ("eager", builder._eager_forward)):
        call = functools.partial(forward, observations, actions, builder.generator)
        forward_ms = statistics.median(synchronised_ms(lambda _: call(), 5, warm=1))
        kernels, _ = profile_steps(call, 2)
        busy_ms = sum(k[1] for k in kernels)
        batch_forward[way] = dict(ms=forward_ms, device_busy_ms=busy_ms,
                                  idle_share=1 - busy_ms / forward_ms,
                                  kernels=sum(k[2] for k in kernels))
    record = dict(batches=batches, batch=LOOP_BATCH, ragged=GRAPHED_RAGGED, frames=EVAL_FRAMES,
                  launches_per_batch=forwards[0], bit_exact=True, programs=captures,
                  eager_s_per_batch=eager_s / batches,
                  graphed_first_s_per_batch=first_s / batches,
                  graphed_s_per_batch=again_s / batches,
                  speedup=eager_s / again_s,
                  batch_forward=batch_forward,
                  eager_peak_gib=eager_gib,
                  graphed_first_peak_gib=first_gib, graphed_peak_gib=again_gib,
                  card=nvidia_smi())
    emit(phase="graphed_builder", **record)
    return launches


def graphed_routes_phase(root: str, route: dict) -> dict:
    """Phase 18 on BAIR's model config with seeded weights; ``route`` is
    phase 6's timing of the play route both ways, printed beside the
    builder's.  Returns the launches of its graphed runs."""
    config = loop_config(root)
    model = make_model(config, "cuda", SEED)
    rng = np.random.default_rng(SEED + 18)
    obs = rng.uniform(-1, 1, (256, 256, 3)).astype(np.float32)
    actions = rng.integers(0, config["data"]["actions_count"], ROLLOUT_FRAMES)
    totals = dict.fromkeys(KERNELS, 0)
    add_launches(totals, graphed_play(model, obs, actions, noise=True))
    reload_state = make_model(config, "cuda", SEED + 18).state_dict()
    add_launches(totals, graphed_play(model, obs, actions, noise=False,
                                      reload_state=reload_state))
    add_launches(totals, graphed_builder(config, model))
    emit(phase="graphed_routes", launches=totals,
         play={way: {k: route[way][k] for k in ("play_step_ms", "play_step_p90_ms",
                                                 "interactive_u8_ms", "rollout_fps",
                                                 "kernels_per_step", "device_idle_share")}
               for way in ("graphed", "eager")})
    return totals


# Phase 19, the graphed training step and evaluation batch: the flagship
# trainer at batch 16 x 12 graphed and op by op from one seeded state, its
# pretraining step and two full-phase steps (the Gumbel temperature new at
# each, the third replaying the second's graph) under deterministic
# algorithms with phase 15's cuBLAS setting; an evaluation batch and a play
# step of the graphed trainer's model captured before its steps and run
# again after them, against a fresh model loaded from its state; then one
# 8 x 30 evaluation batch of BAIR's config both ways.
GRAPHED_TRAIN_STEPS = 3
EVAL_TIMED = 3


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms`` within the block, with the
    cuBLAS workspace setting that phase 15 gives its ranks."""
    saved = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if saved is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved


def stale_weights_check(trainer: Trainer, evaluator: Evaluator, session: PlaySession,
                        obs: np.ndarray, config: dict) -> tuple:
    """Phase 19's check that what ran after graphed steps read the updated
    weights and statistics: ``evaluator`` and ``session``, captured on the
    trainer's model before its steps, against a fresh model loaded from
    ``trainer.state.state_dict()``: one evaluation batch's metrics and one
    play step bit for bit, each program captured again.  Returns the
    record and the fresh model."""
    fresh = make_model(trainer.config, "cuda", SEED + 19)
    fresh.load_state_dict(trainer.state.state_dict()["model"])
    got = evaluator.evaluate(1, save_images=False)
    want = Evaluator(config, fresh, evaluator.dataset, Logger(),
                     vgg=evaluator.vgg).evaluate(1, save_images=False)
    require(got.keys() == want.keys() and all(got[k] == want[k] for k in want),
            f"the evaluation after graphed training differs from a fresh model's: "
            f"{[(k, got.get(k), v) for k, v in want.items() if got.get(k) != v][:5]}")
    with eval_mode(trainer.model):
        frame = session.start(obs).generate_next(2)
    require_equal(frame, PlaySession(fresh).start(obs).generate_next(2),
                  "the play step after graphed training against a fresh model's")
    captures = dict(evaluation=[p.captures for p in evaluator._programs.values()],
                    play=session._programs["step"].captures)
    require(captures == dict(evaluation=[2], play=2),
            f"the programs captured before training were not captured again: {captures}")
    return dict(fresh_model_bit_exact=True, captures=captures), fresh


def timed_evaluation(config: dict, model, dataset, vgg) -> dict:
    """One 8 x 30 evaluation batch (``max_evaluation_batches`` 1) through
    ``Evaluator.evaluate`` graphed and op by op: the metrics bit for bit,
    seconds per batch (the first graphed one with its capture, then the
    median of EVAL_TIMED), launches per batch, and one batch's device busy
    time and kernels under the profiler."""
    want_launches = {"convlstm_gates": EVAL_GATE_LAUNCHES, "convlstm_gates_bwd": 0,
                     "fused_norm_act": len(EVAL_NORM_SHAPES)}
    timed, launches = {}, dict.fromkeys(KERNELS, 0)
    for way, backend in (("graphed", None), ("eager", graphs.Eager)):
        evaluator = Evaluator(config, model, dataset, Logger(), vgg=vgg, backend=backend)

        def evaluate():
            return evaluator.evaluate(2, save_images=False)

        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        first = evaluate()
        first_s = time.perf_counter() - start
        seconds = []
        for _ in range(EVAL_TIMED):
            start = time.perf_counter()
            require(evaluate() == first, f"{way}: an evaluation's metrics moved")
            seconds.append(time.perf_counter() - start)
        counted = read_launches()
        require(counted == {k: v * (1 + EVAL_TIMED) for k, v in want_launches.items()},
                f"{way} evaluation batches launched {counted}")
        if way == "graphed":
            add_launches(launches, counted)
        kernels, wall_ms = profile_steps(evaluate, 2)
        busy_ms = sum(k[1] for k in kernels)
        timed[way] = dict(first_s=first_s, s_per_batch=statistics.median(seconds),
                          s_per_batch_all=seconds, device_busy_ms=busy_ms,
                          idle_share=1 - busy_ms / (statistics.median(seconds) * 1e3),
                          kernels=sum(k[2] for k in kernels), profiled_wall_ms=wall_ms,
                          metrics=first)
    require(timed["graphed"]["metrics"] == timed["eager"]["metrics"],
            "the graphed evaluation batch differs from the op-by-op one")
    for record in timed.values():
        del record["metrics"]
    emit(phase="graphed_evaluation", batch=LOOP_BATCH, frames=EVAL_FRAMES, bit_exact=True,
         launches_per_batch=want_launches, speedup=(timed["eager"]["s_per_batch"]
                                                    / timed["graphed"]["s_per_batch"]),
         card=nvidia_smi(), **timed)
    return launches


def graphed_training_phase(root: str, train_times: dict) -> dict:
    """Phase 19; ``train_times`` is phase 9's timing both ways, printed
    beside this phase's.  Returns the launches of its graphed runs."""
    config = loop_config(root)
    config["evaluation"]["max_evaluation_batches"] = 1
    validation = loop_datasets(config)["validation"]
    validation.set_observations_count(EVAL_FRAMES)
    vgg = make_metric_vgg(None, "cuda")
    batch = device_batch(make_synthetic_batch(
        batch_size=TRAIN_BATCH, observations_count=TRAIN_FRAMES, height=256, width=256,
        seed=SEED))
    obs = np.random.default_rng(SEED + 19).uniform(
        -1, 1, batch.observations.shape[2:]).astype(np.float32)
    want_step = {"convlstm_gates": 6 * DYNAMICS_STEPS, "convlstm_gates_bwd": 3 * DYNAMICS_STEPS,
                 "fused_norm_act": 0}
    totals, graphed_steps, records = dict.fromkeys(KERNELS, 0), [], {}
    for way, backend in (("graphed", None), ("eager", graphs.Eager)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = flagship_trainer(backend)
        record = records[way] = {}
        if way == "graphed":
            # Captured before the steps, on the model they train.
            evaluator = Evaluator(config, trainer.model, validation, Logger(), vgg=vgg)
            reset_launches()
            evaluator.evaluate(0, save_images=False)
            session = PlaySession(trainer.model)
            with eval_mode(trainer.model):
                session.start(obs).generate_next(1)
            add_launches(totals, read_launches())
        step_metrics = []
        with deterministic():
            for step in range(GRAPHED_TRAIN_STEPS):
                reset_launches()
                metrics = trainer.train_step(batch)
                torch.cuda.synchronize()
                launches = read_launches()
                require(launches == want_step, f"{way} step {step + 1} launched {launches}")
                snapshot = state_snapshot(trainer)
                step_metrics.append(metrics)
                if way == "graphed":
                    add_launches(totals, launches)
                    graphed_steps.append((metrics, snapshot))
                    continue
                want_metrics, want_state = graphed_steps[step]
                require(metrics.keys() == want_metrics.keys()
                        and all(metrics[k] == want_metrics[k] for k in metrics),
                        f"step {step + 1}: the graphed step's metrics differ from the eager "
                        f"one's: {[(k, want_metrics[k], v) for k, v in metrics.items() if want_metrics[k] != v][:5]}")
                require_same_state(want_state, snapshot)
        record["deterministic_peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        record["steps"] = [dict(step=i + 1, pretraining=bool(m["pretraining"]),
                                gumbel_temperature=m["gumbel_temperature"],
                                ground_truth_observations=m["ground_truth_observations"],
                                loss=m["loss"]) for i, m in enumerate(step_metrics)]
        record["captures"] = trainer.captures
        if way == "graphed":
            require([s["pretraining"] for s in record["steps"]] == [True, False, False]
                    and len({s["gumbel_temperature"] for s in record["steps"]}) == 3,
                    record["steps"])
            reset_launches()
            stale, fresh = stale_weights_check(trainer, evaluator, session, obs, config)
            add_launches(totals, read_launches())
            record.update(stale)
            del evaluator, session
        # Past the deterministic steps: a step with the schedules' next key
        # (captured on the graphed side), then the timed ones.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        record["capture_step_peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        timing = time_train(trainer, batch, way)
        if way == "graphed":
            add_launches(totals, read_launches())
        record.update({k: timing[k] for k in (
            "train_step_ms", "train_step_ms_all", "train_frames_per_sec", "peak_memory_gib",
            "step_device_busy_ms", "device_idle_share", "kernels_per_step")})
        record["captures_after"] = trainer.captures
        del trainer
    emit(phase="graphed_training", batch=TRAIN_BATCH, frames=TRAIN_FRAMES,
         deterministic_steps=GRAPHED_TRAIN_STEPS, bit_exact=True, launches_per_step=want_step,
         speedup=records["eager"]["train_step_ms"] / records["graphed"]["train_step_ms"],
         phase9=train_times and {way: {k: train_times[way][k] for k in (
             "train_step_ms", "train_frames_per_sec", "device_idle_share", "kernels_per_step",
             "peak_memory_gib")} for way in ("graphed", "eager")},
         card=nvidia_smi(), **records)
    gc.collect()
    torch.cuda.empty_cache()
    add_launches(totals, timed_evaluation(config, fresh, validation, vgg))
    emit(phase="graphed_training_phase", launches=totals)
    return totals


KERNEL_NAME = re.compile(r"\d+([a-z_]+?_kernel)I(13__nv_bfloat16|f)(?:Li(\d+)E)?")
PTXAS_KERNEL = re.compile(r"(?:Compiling entry function '|Function properties for )([\w$]+)")
PTXAS_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
PTXAS_REGISTERS = re.compile(r"Used (\d+) registers")
SASS_KERNEL = re.compile(r"Function : (\S+)")
SASS_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?!NOP\b)\S")
GATE_KERNEL_PACK = re.compile(r"gates_(?:fwd|bwd)_kernel<\w+,(\d+)>")


def kernel_label(mangled: str) -> str:
    """'gates_fwd_kernel<bf16,8>' for a kernel's mangled name."""
    m = KERNEL_NAME.search(mangled)
    if m is None:
        return mangled
    args = ["bf16" if m.group(2) == "13__nv_bfloat16" else "f32"]
    return f"{m.group(1)}<{','.join(args + [m.group(3)] * bool(m.group(3)))}>"


def kernel_report(logs: dict, libraries=None) -> dict:
    """Each kernel's registers and spills from nvcc's ``-Xptxas=-v`` output
    and, where the toolkit has ``cuobjdump``, its static SASS instruction
    count (NOPs aside) in ``libraries`` (default: the port's), and per
    element for the gate kernels."""
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
    if libraries is None:
        libraries = [build.library_path(name) for name in build.sources()]
    for library in libraries:
        sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        for line in sass.splitlines():
            if m := SASS_KERNEL.search(line):
                current = report.setdefault(kernel_label(m.group(1)), {})
                current["sass_instructions"] = 0
            elif SASS_INSTRUCTION.search(line):
                current["sass_instructions"] += 1
    # The gate kernels take one step of N elements per thread, so their
    # static count over N is their issue per element.
    for label, entry in report.items():
        if (m := GATE_KERNEL_PACK.fullmatch(label)) and "sass_instructions" in entry:
            entry["sass_per_element"] = entry["sass_instructions"] / int(m.group(1))
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
    if sys.argv[1:2] == ["--data-parallel-rank"]:  # a process of phase 15 or 16
        data_parallel_rank(sys.argv[2])
        return
    card = nvidia_smi()
    emit(phase="device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    logs = build.build()
    emit(phase="build", seconds=time.perf_counter() - t0, sources=build.sources(),
         kernels=kernel_report(logs))

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errors = check_kernels(gen)
    nms_error = check_nms_kernel(gen)
    check_gate_autograd(gen)

    rng = np.random.default_rng(SEED)
    obs = rng.uniform(-1, 1, (256, 256, 3)).astype(np.float32)
    actions = rng.integers(0, 7, ROLLOUT_FRAMES)
    model = flagship_model("cuda", torch.bfloat16, SEED)
    play_launches = play_route(model, obs, actions)
    check_norm_call(model, gen)
    route_parity(obs, actions)

    sums = time_kernels(gen)
    time_loop_kernels(gen)
    route = time_route(model, obs, actions)
    del model

    trainer = flagship_trainer()
    batch = device_batch(make_synthetic_batch(
        batch_size=TRAIN_BATCH, observations_count=TRAIN_FRAMES, height=256, width=256,
        seed=SEED))
    train_launches = train_route(trainer, batch)
    train_parity()
    sums["convlstm_gates_bwd"] = time_gate_kernels_in_training(gen)
    train_times = time_train_both_ways(trainer, batch)
    del trainer, batch

    with tempfile.TemporaryDirectory() as root:
        loop_launches, loop_step_ms = train_loop(root)
        after_launches, eval_config, pair = after_training(root)
        distribution_metrics(root, eval_config, pair)
        soak_launches = convergence_soak_phase(root, gen)
        detector = detector_phase(root)
        parallel_launches, phase15 = data_parallel_phase(root)
        tensor_parallel_launches = tensor_parallel_phase(root, phase15)
        tools_launches = tools_phase(root, loop_step_ms)
        graphed_launches = graphed_routes_phase(root, route)
        graphed_training_launches = graphed_training_phase(root, train_times)

    kernels = [dict(name=name, route="cuda",
                    source=f"playablevideogeneration_tpu_torch/ops/cuda/csrc/{source}.cu",
                    replaces=replaces,
                    launches=(play_launches[name] + train_launches[name] + loop_launches[name]
                              + after_launches[name] + soak_launches[name]
                              + parallel_launches[name] + tensor_parallel_launches[name]
                              + tools_launches[name] + graphed_launches[name]
                              + graphed_training_launches[name]),
                    max_abs_err=errors[name], ms=sums[name]["ms"],
                    cold_ms=sums[name]["cold_ms"],
                    plain_ms=sums[name]["plain_ms"], bound_ms=sums[name]["bound_ms"],
                    bound_by=sums[name]["bound_by"], library_ms=None)
               for name, (source, replaces) in KERNELS.items()]
    # K4's times are per 16-frame detector call (its three nms_keep calls,
    # six launches), its launches those of phase 14's main path; no PyTorch
    # call computes greedy NMS (torchvision's nms is not on the card's
    # machine).
    kernels.append(dict(NMS_KERNEL, route="cuda", launches=detector["launches"],
                        max_abs_err=max(nms_error, detector["max_abs_err"]),
                        **{key: detector["times"][key]
                           for key in ("ms", "cold_ms", "plain_ms", "bound_ms", "bound_by")},
                        library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
