"""Drives the PyTorch/CUDA port's play and training routes on one NVIDIA
Hopper GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on a failed check:

1. device: a CUDA device must be visible; prints nvidia-smi's name and
   power limit;
2. build: compiles every kernel under
   ``playablevideogeneration_tpu_torch/ops/cuda/csrc`` with nvcc for sm_90a;
3. kernels: holds each kernel against its plain PyTorch version on the card
   at every shape the flagship's play and training steps give it, plus a
   ragged gate case, in f32 (tolerance 1e-5) and bf16 (tolerance one bf16
   ulp: rtol 2^-7, atol 1e-5); and the gate update's autograd function
   (K1 forward, K2 backward) against autograd through the plain gate math;
4. play route: the bf16 flagship (configs/01_bair.yaml, seeded random
   weights and BatchNorm statistics) through ``PlaySession``: start, three
   ``generate_next``, ``generate_next_u8``, ``generate_next_interpolation``
   and a 64-action ``rollout``; every step must launch the gate kernel 3
   times and the norm kernel 15 times, frames must be finite and in
   [-1, 1], and the rollout must synchronise with the host once;
5. parity: the same weights in f32 with TF32 off through the kernels on the
   card, and through the plain versions on the CPU; three steps must agree
   to 1e-3;
6. timings: each kernel's device time per launch at its flagship shapes
   beside its memory bound and its plain version's time, the play step's
   latency, the rollout's frame rate, and the step's device-time breakdown;
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
   shapes beside their bounds and plain versions' times, the median bf16
   train step, ``train_frames_per_sec`` (B*T per step), peak device memory,
   and the device's busy and idle share and kernel-time breakdown over two
   profiled steps (the port's kernels listed one by one).

It prints JSON lines as it goes, then the kernels' summary line (``ms``,
``plain_ms`` and ``bound_ms`` there are per step of the kernel's route: the
sum over a bf16 play step's launches for K1 and K3, over a bf16 training
step's 33 K2 launches for K2; ``launches`` counts phase 4's run for K3,
phase 7's for K2 and both for K1), the card's nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from playablevideogeneration_tpu_torch.inference.play_session import PlaySession
from playablevideogeneration_tpu_torch.models.caddy import flagship_model
from playablevideogeneration_tpu_torch.ops.cuda import build
from playablevideogeneration_tpu_torch.ops.cuda.convlstm_gates import (
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
from playablevideogeneration_tpu_torch.training.trainer import Trainer
from playablevideogeneration_tpu_torch.ops.cuda.fused_norm_act import (
    _scale_shift_leaky_relu,
    fold_batch_norm,
    fused_scale_shift_leaky_relu,
)

SEED = 0
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
# Shapes (C, H, W) at batch 1 of every launch in one flagship play step.
GATE_SHAPES = [(128, 32, 32), (256, 16, 16), (128, 32, 32)]  # lstm0, lstm1, lstm2
NORM_SHAPES = [
    (16, 128, 128), (16, 128, 128),   # E: bn1, res0.bn1
    (32, 64, 64), (32, 64, 64),       # E: res1.bn1, res2.bn1
    (64, 32, 32), (64, 32, 32),       # E: res3.bn1, res4.bn1
    (65, 32, 32),                     # E: res5.bn1 (state + attention)
    (256, 16, 16), (128, 16, 16),     # R: same0.bn1, up0.norm
    (128, 32, 32),                    # R: same1.bn1
    (128, 64, 64), (128, 64, 64),     # D: up0.norm, res0.bn1
    (64, 128, 128), (64, 128, 128),   # D: up1.norm, res1.bn1
    (32, 256, 256),                   # D: up2.norm
]
# Kernel-name fragments that sort the profiled step's device time.
KERNEL_GROUPS = [
    ("port_kernels", ("gates_fwd_kernel", "gates_bwd_kernel",
                      "scale_shift_leaky_relu_kernel")),
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


def gate_inputs(shape, dtype, gen):
    c, h, w = shape
    gates = (torch.randn((1, 4 * c, h, w), generator=gen, device="cuda") * 2).to(dtype)
    cell = torch.randn((1, c, h, w), generator=gen, device="cuda").to(dtype)
    return gates, cell


def norm_inputs(shape, dtype, gen):
    c, h, w = shape
    x = torch.randn((1, c, h, w), generator=gen, device="cuda").to(dtype)
    scale = torch.rand(c, generator=gen, device="cuda") + 0.5
    bias = torch.randn(c, generator=gen, device="cuda") * 0.1
    mean = torch.randn(c, generator=gen, device="cuda") * 0.1
    var = torch.rand(c, generator=gen, device="cuda") * 1.5 + 0.5
    a, b = fold_batch_norm(scale, bias, mean, var)
    return x, a.to(dtype).float(), b.to(dtype).float()


def check_kernels(gen) -> dict:
    """Phase 3; returns the largest error of each kernel."""
    errors = {"convlstm_gates": 0.0, "fused_norm_act": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        cases = [("convlstm_gates", s, gate_inputs(s, dtype, gen), fused_lstm_gates,
                  _gate_math) for s in GATE_SHAPES + [(65, 25, 40)]]
        cases += [("fused_norm_act", s, norm_inputs(s, dtype, gen),
                   fused_scale_shift_leaky_relu, _scale_shift_leaky_relu)
                  for s in NORM_SHAPES]
        for name, shape, args, kernel, plain in cases:
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = 0.0
            for g, w in zip(got, want):
                require(g.dtype == dtype and g.shape == w.shape, (name, shape))
                torch.testing.assert_close(g.float(), w.float(), **TOLERANCE[dtype],
                                           msg=lambda m: f"{name} {shape} {dtype}: {m}")
                err = max(err, (g.float() - w.float()).abs().max().item())
            errors[name] = max(errors[name], err)
            emit(phase="kernel_check", kernel=name, shape=shape,
                 dtype=DTYPE_NAMES[dtype], max_abs_err=err)
    return errors


def gate_backward_inputs(shape, dtype, gen):
    b, c, h, w = shape
    gates = (torch.randn((b, 4 * c, h, w), generator=gen, device="cuda") * 2).to(dtype)
    return (gates,) + tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                            for _ in range(3))  # c, dh, dc


def check_gate_backward(gen) -> float:
    """Phase 3, K2: returns its largest error against ``_gate_math_bwd``."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in GATE_TRAIN_SHAPES + [GATE_RAGGED_SHAPE]:
            args = gate_backward_inputs(shape, dtype, gen)
            got, want = fused_lstm_gates_bwd(*args), _gate_math_bwd(*args)
            torch.cuda.synchronize()
            err = 0.0
            for g, w in zip(got, want):
                require(g.dtype == dtype and g.shape == w.shape, ("gate_bwd", shape))
                torch.testing.assert_close(g.float(), w.float(), **TOLERANCE[dtype],
                                           msg=lambda m: f"gate_bwd {shape} {dtype}: {m}")
                err = max(err, (g.float() - w.float()).abs().max().item())
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


def play_route(model, obs: np.ndarray, actions: np.ndarray) -> dict:
    """Phase 4 on the bf16 flagship; returns the launch counts."""
    session = PlaySession(model)
    reset_launches()
    session.start(obs)
    frames = [session.generate_next(int(a)) for a in actions[:3]]
    u8 = session.generate_next_u8(int(actions[3]))
    frames.append(session.generate_next_interpolation(0, 3, 0.7))
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rollout = session.rollout(actions[:ROLLOUT_FRAMES])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in syncs
             if "called a synchronizing CUDA operation" in str(w.message)]
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
    before = fused_lstm_gates.launches, fused_scale_shift_leaky_relu.launches
    err = 0.0
    for a in actions[:3]:
        got, want = gpu.generate_next(int(a)), cpu.generate_next(int(a))
        check_frame(got, (256, 256, 3))
        err = max(err, float(np.abs(got - want).max()))
    counts = (fused_lstm_gates.launches - before[0],
              fused_scale_shift_leaky_relu.launches - before[1])
    require(counts == (9, 45), f"f32 route launched {counts}, not (9, 45)")
    for (gh, gc), (ch, cc) in zip(gpu.carry, cpu.carry):
        err = max(err, (gh.cpu() - ch).abs().max().item(), (gc.cpu() - cc).abs().max().item())
    require(err <= 1e-3, f"f32 route differs from the CPU plain path by {err}")
    emit(phase="route_parity", dtype="f32", tf32=False, steps=3, max_abs_err=err,
         tolerance=1e-3)
    return err


def time_kernels(gen) -> dict:
    """Phase 6a: device time, bound and plain time of every launch of one
    bf16 play step; returns per-kernel sums over the step."""
    dtype = torch.bfloat16
    size = 2  # bytes per bf16 element
    sums = {}
    # Per state element K1 reads 4 gates and c and writes h' and c'; per
    # element K3 reads x and writes y (and reads 8 bytes per channel of a, b).
    cases = [("convlstm_gates", s, gate_inputs(s, dtype, gen), fused_lstm_gates, _gate_math,
              7 * size, GATE_OPS_PER_ELEMENT) for s in GATE_SHAPES]
    cases += [("fused_norm_act", s, norm_inputs(s, dtype, gen),
               fused_scale_shift_leaky_relu, _scale_shift_leaky_relu, 2 * size,
               NORM_OPS_PER_ELEMENT) for s in NORM_SHAPES]
    for name, shape, args, kernel, plain, bytes_per_element, ops in cases:
        elements = shape[0] * shape[1] * shape[2]
        extra_bytes = 8 * shape[0] if name == "fused_norm_act" else 0
        bound, bound_by = bound_ms(elements * bytes_per_element + extra_bytes,
                                   elements * ops)
        ms = device_ms(lambda: kernel(*args))
        plain_ms = device_ms(lambda: plain(*args))
        emit(phase="kernel_time", kernel=name, shape=shape, dtype="bf16", us=ms * 1e3,
             bound_us=bound * 1e3, bound_by=bound_by, plain_us=plain_ms * 1e3)
        total = sums.setdefault(name, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                           bound_by=bound_by))
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += bound
    return sums


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
    fused_scale_shift_leaky_relu.launches = 0


def read_launches() -> dict:
    return {"convlstm_gates": fused_lstm_gates.launches,
            "convlstm_gates_bwd": fused_lstm_gates_bwd.launches,
            "fused_norm_act": fused_scale_shift_leaky_relu.launches}


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
    """Phase 9a: K1's and K2's device time, bound and plain time per launch
    at the training shapes (bf16); returns K2's sums over one training
    step (K1's summary stays that of the play step)."""
    dtype, size = torch.bfloat16, 2
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for shape in GATE_TRAIN_SHAPES:
        args = gate_backward_inputs(shape, dtype, gen)
        elements = args[1].numel()
        # Per state element K1 reads 4 gates and c and writes h' and c'; K2
        # reads 4 gates, c, dh and dc and writes 4 gate gradients and
        # dc_prev.
        for name, kernel, plain, kernel_args, bytes_per_element, ops in (
                ("convlstm_gates", fused_lstm_gates, _gate_math, args[:2], 7 * size,
                 GATE_OPS_PER_ELEMENT),
                ("convlstm_gates_bwd", fused_lstm_gates_bwd, _gate_math_bwd, args, 12 * size,
                 GATE_BWD_OPS_PER_ELEMENT)):
            bound, bound_by = bound_ms(elements * bytes_per_element, elements * ops)
            ms = device_ms(lambda: kernel(*kernel_args))
            plain_ms = device_ms(lambda: plain(*kernel_args), launches=20)
            emit(phase="kernel_time", kernel=name, shape=shape, dtype="bf16", us=ms * 1e3,
                 bound_us=bound * 1e3, bound_by=bound_by, plain_us=plain_ms * 1e3)
            if name == "convlstm_gates_bwd":
                total["ms"] += ms * DYNAMICS_STEPS
                total["plain_ms"] += plain_ms * DYNAMICS_STEPS
                total["bound_ms"] += bound * DYNAMICS_STEPS
                total["bound_by"] = bound_by
    return total


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
         ptxas=[line.strip() for log in logs.values() for line in log.splitlines()
                if "registers" in line or "spill" in line])

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errors = check_kernels(gen)
    errors["convlstm_gates_bwd"] = check_gate_backward(gen)

    rng = np.random.default_rng(SEED)
    obs = rng.uniform(-1, 1, (256, 256, 3)).astype(np.float32)
    actions = rng.integers(0, 7, ROLLOUT_FRAMES)
    model = flagship_model("cuda", torch.bfloat16, SEED)
    play_launches = play_route(model, obs, actions)
    route_parity(obs, actions)

    sums = time_kernels(gen)
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

    kernels = [dict(name=name, route="cuda",
                    source=f"playablevideogeneration_tpu_torch/ops/cuda/csrc/{source}.cu",
                    replaces=replaces, launches=play_launches[name] + train_launches[name],
                    max_abs_err=errors[name], ms=sums[name]["ms"],
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
