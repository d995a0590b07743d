"""Drives the PyTorch/CUDA port's play route on one NVIDIA Hopper GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on a failed check:

1. device: a CUDA device must be visible; prints nvidia-smi's name and
   power limit;
2. build: compiles every kernel under
   ``playablevideogeneration_tpu_torch/ops/cuda/csrc`` with nvcc for sm_90a;
3. kernels: holds each kernel against its plain PyTorch version on the card
   at every shape the flagship play step gives it, in f32 (tolerance 1e-5)
   and bf16 (tolerance one bf16 ulp: rtol 2^-7, atol 1e-5);
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
   latency, the rollout's frame rate, and the step's device-time breakdown.

It prints JSON lines as it goes, then the kernels' summary line (``ms``,
``plain_ms`` and ``bound_ms`` there are per play step: the sum over the
step's launches at their bf16 shapes; ``launches`` counts phase 4's run),
the card's nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
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
    fused_lstm_gates,
)
from playablevideogeneration_tpu_torch.ops.cuda.fused_norm_act import (
    _scale_shift_leaky_relu,
    fold_batch_norm,
    fused_scale_shift_leaky_relu,
)

SEED = 0
# The Pallas TPU kernel (its pl.pallas_call) that each CUDA kernel replaces.
REPLACES = {
    "convlstm_gates": "playablevideogeneration_tpu/ops/pallas/convlstm_gates.py:119",
    "fused_norm_act": "playablevideogeneration_tpu/ops/pallas/fused_norm_act.py:71",
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
    ("port_kernels", ("gates_fwd_kernel", "scale_shift_leaky_relu_kernel")),
    ("layout_transpose", ("nchwToNhwc", "nhwcToNchw", "tensorTransform")),
    ("convolution", ("fprop", "xmma", "winograd", "cutlass", "gemm", "conv")),
    ("upsample", ("upsample",)),
    ("batch_norm", ("batch_norm",)),
    ("copy_cast", ("copy",)),
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


def check_frame(frame: np.ndarray, shape) -> None:
    require(frame.shape == shape, frame.shape)
    require(np.isfinite(frame).all(), "non-finite frame")
    require(frame.min() >= -1.0 and frame.max() <= 1.0, (frame.min(), frame.max()))


def play_route(model, obs: np.ndarray, actions: np.ndarray) -> dict:
    """Phase 4 on the bf16 flagship; returns the launch counts."""
    session = PlaySession(model)
    fused_lstm_gates.launches = 0
    fused_scale_shift_leaky_relu.launches = 0
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
    launches = {"convlstm_gates": fused_lstm_gates.launches,
                "fused_norm_act": fused_scale_shift_leaky_relu.launches}
    steps = 3 + 1 + 1 + ROLLOUT_FRAMES
    require(launches == {"convlstm_gates": 3 * steps, "fused_norm_act": 15 * steps},
            f"{steps} steps launched {launches}")
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
    groups = {}
    for name, ms, calls in kernels:
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)),
                     "other")
        total = groups.setdefault(group, dict(ms=0.0, calls=0.0))
        total["ms"] += ms
        total["calls"] += calls
    emit(phase="step_breakdown", groups=groups,
         top=[dict(kernel=k[0][:90], ms=k[1], calls=k[2]) for k in kernels[:20]])
    return route


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

    rng = np.random.default_rng(SEED)
    obs = rng.uniform(-1, 1, (256, 256, 3)).astype(np.float32)
    actions = rng.integers(0, 7, ROLLOUT_FRAMES)
    model = flagship_model("cuda", torch.bfloat16, SEED)
    launches = play_route(model, obs, actions)
    route_parity(obs, actions)

    sums = time_kernels(gen)
    time_route(model, obs, actions)

    kernels = [dict(name=name, route="cuda",
                    source=f"playablevideogeneration_tpu_torch/ops/cuda/csrc/{name}.cu",
                    replaces=replaces, launches=launches[name], max_abs_err=errors[name],
                    ms=sums[name]["ms"], plain_ms=sums[name]["plain_ms"],
                    bound_ms=sums[name]["bound_ms"], bound_by=sums[name]["bound_by"],
                    library_ms=None)
               for name, replaces in REPLACES.items()]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
