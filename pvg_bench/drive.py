"""The general generator: one driver per kind of request, parameterised by a
traffic mix's data file.

A mix names its ``driver``:

- ``train``: ``Trainer.train_step`` fed by ``Trainer.dataloader`` over
  seeded in-memory videos, iterated as ``Trainer.train_epoch`` iterates
  it (a new epoch where one ends), from ``global_step``;
- ``interactive``: one player in a closed loop, one
  ``PlaySession.generate_next_u8(action)`` per frame, actions uniform over
  the config's, each held for a geometric run of frames, ``start`` from a
  new seeded observation every ``segment_frames``;
- ``rollout``: one client in a closed loop, each request ``start`` from a
  new seeded observation and ``PlaySession.rollout`` of
  ``rollout_frames`` seeded actions.

Each driver builds the program from the seed, warms up every shape the mix
uses, measures for the window, optionally traces a stretch after it, reads
the device's peak memory, frees the program and then checks what the
window's path produced against the reference (``pvg_bench.reference``).

Another kind of request is a file of its own, ``drivers/<driver>.py``,
found by the mix's ``driver`` where no driver here has that name
(``load_driver``).  It defines ``run(cell: Cell) -> Outcome`` and follows
the steps above; ``run.py`` and ``readers.py`` then take its ``Outcome``
unchanged where it holds:

- ``end_to_end``: a value for each end-to-end metric but ``setup_s`` that
  lists the cell under its ``workloads`` in ``BENCHMARK.json``, over all
  the work and all the time of the window;
- ``context["window_start"]`` and ``["window_s"]``, the window's start on
  ``time.perf_counter`` (set-up ends there) and its length, and
  ``["traced_end"]``, when the traced stretch (or the window, untraced)
  ended; ``frames`` and ``traced_frames``, or ``steps`` and
  ``traced_steps``, the work of the window and of the traced stretch;
- ``checks``: ``check.judged(numbers, cell.limits)``, each compared number
  beside its limit from ``limits/<workload>.json``, as ``check.passed``
  reads them, computed once the window has closed and the program is
  freed;
- ``memory_peak_bytes``: ``peak_memory`` read before the program is freed;
- ``trace``: with ``cell.trace``, ``traced_twice`` of a stretch after the
  window, else None.

Such a driver checks against a plain float32 reference of its own, a
module under ``reference/`` that imports nothing of the port and nothing
of JAX.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import math
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pvg_bench import check, trace as tracing, videos
from pvg_bench.reference import data as ref_data
from pvg_bench.reference import model as ref
from pvg_bench.reference import train as ref_train
from pvg_bench.stats import percentile, rate
from pvg_bench.weights import seeded_state_dicts


@dataclass
class Cell:
    workload: str
    config: dict  # as the program takes it
    traffic: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: torch.device


@dataclass
class Outcome:
    attempted: int
    end_to_end: Dict[str, float]
    context: dict  # what the per-layer readers read
    checks: Dict[str, dict]
    memory_peak_bytes: int
    readings: Dict[str, float] = field(default_factory=dict)  # shown, not compared
    trace: Optional[tracing.Trace] = None


@dataclass
class _Window:
    start: float
    end: float = 0.0
    samples: List[float] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start


def peak_memory(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def release(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference_models(config: dict, precision: ref.Precision, vgg: bool):
    """The reference's Caddy (and VGG19), empty on the meta device."""
    with torch.device("meta"):
        model = ref.Caddy(config, precision)
        return [model, ref.Vgg19(precision)] if vgg else [model]


def loaded_reference(config: dict, seed: int, device, precision: ref.Precision, vgg: bool):
    """The reference's models on ``device`` with the seed's weights."""
    models = reference_models(config, precision, vgg)
    for model, state in zip(models, seeded_state_dicts(models, seed, device)):
        model.to_empty(device=device)
        model.load_state_dict(state)
    return models


def program_weights(config: dict, seed: int, device, vgg: bool):
    """The seed's state dicts, made on the device, for the program."""
    return seeded_state_dicts(reference_models(config, ref.FLOAT32, vgg), seed, device)


@contextlib.contextmanager
def tf32_off():
    """Float32 products in float32 (the reference's), as they were after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def traced_twice(stretch: Callable[[bool], None]) -> tracing.Trace:
    """The stretch traced for the device alone (busy time, kernels), then
    again with the host's events, whose idle gaps go into the breakdown."""
    _, device = tracing.traced(lambda: stretch(False), host=False)
    _, host = tracing.traced(lambda: stretch(True), host=True)
    device.idle_gaps_by_host = host.idle_gaps()
    return device


# ---------------------------------------------------------------------------
# Training.


def train_videos(config: dict, traffic: dict, seed: int):
    """Seeded videos, each long enough for ``samples_per_video`` samples of
    the config's sequence length, stacking and skip."""
    batching = config["training"]["batching"]
    frames = batching["observations_count"]
    block = frames + (frames - 1) * batching["skip_frames"]
    height, width = videos.frame_size(config)
    return [videos.moving_square(seed, i, block + traffic["samples_per_video"] - 1, height,
                                 width, config["data"]["actions_count"])
            for i in range(traffic["videos"])]


def build_trainer(config: dict, traffic: dict, seed: int, device: torch.device):
    """The port's trainer as the train CLI builds it, its loader over the
    seeded videos, the seed's weights loaded, at ``global_step``."""
    from playablevideogeneration_tpu_torch.data.transforms import get_final_transforms
    from playablevideogeneration_tpu_torch.data.video import Video
    from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset
    from playablevideogeneration_tpu_torch.models.caddy import make_model
    from playablevideogeneration_tpu_torch.models.vgg import Vgg19
    from playablevideogeneration_tpu_torch.training.trainer import Trainer
    from playablevideogeneration_tpu_torch.utils.logging import Logger

    clips = [Video().add_content(list(frames), actions, None, None, None)
             for frames, actions in train_videos(config, traffic, seed)]
    dataset = VideoDataset.from_videos(clips, config["training"]["batching"],
                                       get_final_transforms(config)["train"])
    caddy_state, vgg_state = program_weights(config, seed, device, vgg=True)
    model = make_model(config, device, seed)
    model.load_state_dict(caddy_state)
    vgg = Vgg19(model.dtype).to(device)
    vgg.load_state_dict(vgg_state)
    vgg.eval()
    trainer = Trainer(config, model, vgg=vgg, seed=seed, dataset=dataset,
                      smooth_mi=config["training"]["trainer"].endswith("smooth_mi_trainer"),
                      logger=Logger(enabled=False))
    trainer.init_state()
    trainer.global_step = traffic["global_step"]
    dataset.set_observations_count(trainer.get_observations_count())
    return trainer


def _epochs(loader):
    """The loader's batches epoch after epoch, as successive
    ``train_epoch`` calls draw them."""
    while True:
        yield from loader


def _train(cell: Cell) -> Outcome:
    config, traffic, device = cell.config, cell.traffic, cell.device
    trainer = build_trainer(config, traffic, cell.seed, device)
    batches = _epochs(trainer.dataloader)
    params = list(trainer.model.named_parameters())
    beta1 = trainer.state.optimizer.defaults["betas"][0]
    losses, first, first_buffers, after = [], None, None, None
    # The checked steps go through the window's call and feed; with the
    # rest of the warm-up they capture the step's graph and fill the
    # loader's queue.
    for k in range(traffic["warmup_steps"]):
        metrics = trainer.train_step(next(batches))
        if k < traffic["checked_steps"]:
            losses.append(metrics["loss"])
        if k == 0:
            # Adam's first moment after one update is (1 - beta1) times the
            # gradient it took; a parameter it never updated has none.
            state = trainer.state.optimizer.state
            first = {n: (state[p]["exp_avg"] / (1 - beta1) if "exp_avg" in state.get(p, {})
                         else torch.zeros_like(p)).to("cpu", copy=True) for n, p in params}
            first_buffers = {n: b.detach().to("cpu", copy=True)
                             for n, b in trainer.model.named_buffers()}
        if k + 1 == traffic["checked_steps"]:
            after = {n: p.detach().to("cpu", copy=True) for n, p in params}

    b = config["training"]["batching"]["batch_size"]
    frames = trainer.get_observations_count()
    window = _Window(start=time.perf_counter())
    steps = 0
    while True:
        t = time.perf_counter()
        batch = next(batches)
        window.samples.append(time.perf_counter() - t)
        trainer.train_step(batch)
        steps += 1
        if time.perf_counter() - window.start >= cell.seconds:
            break
    window.end = time.perf_counter()
    context = dict(window_start=window.start, window_s=window.seconds, steps=steps,
                   loader_wait_s=sum(window.samples),
                   batch=b, frames=frames, global_step=trainer.global_step)

    trace = None
    if cell.trace:
        def stretch(host: bool):
            for _ in range(traffic["traced_steps"]):
                with tracing.span("loader_next", host):
                    batch = next(batches)
                with tracing.span("train_step", host):
                    trainer.train_step(batch)
        trace = traced_twice(stretch)
        context["traced_steps"] = traffic["traced_steps"]
    context["traced_end"] = time.perf_counter()
    memory = peak_memory(device)
    batches.close()
    trainer.drop_program()
    del trainer, batches, params
    release(device)

    got = dict(losses=losses, first_gradients=first, first_buffers=first_buffers,
               parameters=after)
    numbers, readings = train_numbers(cell, got)
    return Outcome(attempted=steps, checks=check.judged(numbers, cell.limits), readings=readings,
                   end_to_end={"train_frames_per_s": rate(steps * b * frames, window.seconds)},
                   context=context, memory_peak_bytes=memory, trace=trace)


def reference_training(config: dict, traffic: dict, seed: int, device, fp8: bool,
                       half_batch: bool = False) -> dict:
    """The reference's first ``checked_steps`` from the seed: its batches
    worked out again from the videos and the loader's shuffle, its noise
    from a generator seeded as the trainer's."""
    batching = config["training"]["batching"]
    frames = ref_train.schedules(config, traffic["global_step"] + 1)["frames"]
    clips = [frames_ for frames_, _ in train_videos(config, traffic, seed)]
    order = ref_data.epoch_order(ref_data.sample_count([len(c) for c in clips], batching, frames),
                                 batching["batch_size"], seed)
    rows = batching["batch_size"] // 2 if half_batch else batching["batch_size"]
    batches = [torch.from_numpy(ref_data.batch(clips, batching, frames, order[k][:rows]))
               .to(device) for k in range(traffic["checked_steps"])]
    model, vgg = loaded_reference(config, seed, device, ref.Precision(fp8=fp8), vgg=True)
    noise = ref.generator_noise(torch.Generator(device=device).manual_seed(seed))
    with tf32_off():
        return ref_train.train_steps(
            model, vgg, config, batches, noise, traffic["global_step"] + 1,
            smooth_mi=config["training"]["trainer"].endswith("smooth_mi_trainer"))


def train_numbers(cell: Cell, got: dict):
    """The program's checked steps against the reference's."""
    want = reference_training(cell.config, cell.traffic, cell.seed, cell.device, fp8=False)
    return compare_training(got, want, cell.config, cell.seed, cell.device)


# The leaf at which ``descent_gap`` is read: the tenth part of the leaves
# departs less.  Farther in, a bfloat16 step's direction departs from
# float32's as far as fp8's does (``PERF.md``).
DESCENT_QUANTILE = 0.1


def compare_training(got: dict, want: dict, config: dict, seed: int, device
                     ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(the compared numbers, the readings beside them) of one run's checked
    steps (``got``: its losses, first gradients, buffers after the first
    step and parameters after the last, as ``reference_training`` returns
    the reference's) against the reference's (``want``)."""
    start = program_weights(config, seed, device, vgg=True)[0]
    got = {k: v if k == "losses" else {n: t.to(device) for n, t in v.items()}
           for k, v in got.items()}
    leaves = check.kept_leaves(want["first_gradients"])
    norms = {which: {n: float(g.norm()) for n, g in run["first_gradients"].items()}
             for which, run in (("got", got), ("want", want))}
    first = check.norm_gaps(norms["got"], norms["want"], leaves)
    moved = {which: {n: float((run["parameters"][n] - start[n]).norm()) for n in leaves}
             for which, run in (("got", got), ("want", want))}
    change = check.norm_gaps(moved["got"], moved["want"], leaves)
    descent = check.descent_gaps(got["parameters"], want["parameters"], start,
                                 want["first_gradients"], leaves)
    statistic_names = [n for n in want["first_buffers"] if "running_" in n]
    stats = check.moved_gaps(got["first_buffers"], want["first_buffers"], start,
                             statistic_names)
    numbers = dict(
        statistics_gap=statistics.median(stats),
        centroids_gap=check.moved_gaps(got["first_buffers"], want["first_buffers"], start,
                                       ["centroids"])[0],
        update_norm_gap=statistics.median(change),
        descent_gap=float(np.quantile(descent, DESCENT_QUANTILE)))
    readings = dict(
        first_loss_gap=check.relative_loss_gap(got["losses"][:1], want["losses"][:1]),
        loss_gap_worst_step=check.relative_loss_gap(got["losses"], want["losses"]),
        grad_norm_gap=statistics.median(first), grad_norm_gap_worst_leaf=max(first),
        grad_cosine_gap=statistics.median(
            check.cosine_gap(got["first_gradients"][n], want["first_gradients"][n])
            for n in leaves),
        update_norm_gap_worst_leaf=max(change), descent_gap_median=statistics.median(descent),
        descent_gap_worst_leaf=max(descent),
        statistics_gap_worst=max(stats))
    return numbers, readings


# ---------------------------------------------------------------------------
# Play.


def segment_actions(config: dict, seed: int, index: int, count: int, hold_mean: float
                    ) -> List[int]:
    """``count`` actions of request ``index``: uniform over the config's
    actions, each held for a geometric run of mean ``hold_mean`` frames."""
    rng = np.random.default_rng([seed, index, 1])
    actions: List[int] = []
    while len(actions) < count:
        actions += [int(rng.integers(config["data"]["actions_count"]))] * int(
            rng.geometric(1.0 / hold_mean))
    return actions[:count]


def checked_requests(seed: int, finished: List[int], count: int) -> List[int]:
    """A sample of ``count`` finished requests drawn from the seed."""
    rng = np.random.default_rng([seed, 2])
    return sorted(rng.permutation(finished)[:count].tolist()) if finished else []


def build_session(config: dict, seed: int, device: torch.device):
    from playablevideogeneration_tpu_torch.inference.play_session import PlaySession
    from playablevideogeneration_tpu_torch.models.caddy import make_model

    model = make_model(config, device, seed)
    model.load_state_dict(program_weights(config, seed, device, vgg=False)[0])
    model.eval()
    return PlaySession(model, noise=False)


# Request indices: the window's from 0, the warm-up's from here.
WARMUP_REQUEST = 1 << 40


def kept_for_check(seed: int, index: int, share: float) -> bool:
    """Whether the frames of request ``index`` are kept for the check: the
    first always, the others drawn from the seed with probability
    ``share``, so that the sample spans the window and the memory stays
    bounded."""
    return index == 0 or np.random.default_rng([seed, index, 3]).random() < share


def _play(cell: Cell) -> Outcome:
    config, traffic, device, seed = cell.config, cell.traffic, cell.device, cell.seed
    session = build_session(config, seed, device)
    interactive = traffic["driver"] == "interactive"
    length = traffic["segment_frames"] if interactive else traffic["rollout_frames"]

    def serve(index: int, latencies: List[float], stop: Callable[[], bool],
              traced: bool = False):
        """Request ``index``: ``start`` and its frames, interactive frame by
        frame (a list; each latency appended) until ``stop``, or as one
        rollout (an array)."""
        actions = segment_actions(config, seed, index, length, traffic["hold_mean_frames"])
        with tracing.span("start", traced):
            session.start(videos.start_observation(config, seed, index))
        if not interactive:
            with tracing.span("rollout", traced):
                return session.rollout(np.asarray(actions))
        frames = []
        for action in actions:
            t = time.perf_counter()
            with tracing.span("generate_next_u8", traced):
                frames.append(session.generate_next_u8(action))
            latencies.append(time.perf_counter() - t)
            if stop():
                break
        return frames

    never = lambda: False  # noqa: E731
    for k in range(traffic["warmup_requests"]):
        serve(WARMUP_REQUEST + k, [], never)

    kept: Dict[int, list] = {}  # stacked after the window, not inside it
    latencies: List[float] = []
    window = _Window(start=time.perf_counter())
    # The window closes at ``seconds``, once some request kept for the check
    # has finished.
    done = lambda: (time.perf_counter() - window.start >= cell.seconds  # noqa: E731
                    and bool(kept))
    requests = delivered = 0
    while not done():
        keep = kept_for_check(seed, requests, traffic["check_share"])
        frames = serve(requests, latencies, done)
        delivered += len(frames)
        if keep and len(frames) == length:
            kept[requests] = frames
        requests += 1
    window.end = time.perf_counter()
    end_to_end = {"play_fps": rate(delivered, window.seconds)}
    if interactive:
        end_to_end["frame_ms_p95"] = percentile(latencies, 95) * 1e3
    context = dict(window_start=window.start, window_s=window.seconds, frames=delivered,
                   requests=requests,
                   latencies_s=latencies)

    trace = None
    if cell.trace:
        first = WARMUP_REQUEST + traffic["warmup_requests"]

        def stretch(host: bool):
            for k in range(traffic["traced_requests"]):
                serve(first + k, [], never, traced=host)
        trace = traced_twice(stretch)
        context["traced_frames"] = traffic["traced_requests"] * length
    context["traced_end"] = time.perf_counter()
    memory = peak_memory(device)
    del session
    release(device)

    chosen = checked_requests(seed, sorted(kept), traffic["check_requests"])
    gaps = play_gaps(config, traffic, seed, device, {i: np.stack(kept[i]) for i in chosen},
                     fp8=False)
    return Outcome(attempted=requests, end_to_end=end_to_end, context=context,
                   checks=check.judged({"frame_gap": gaps.pop("frame_gap")}, cell.limits),
                   readings=gaps, memory_peak_bytes=memory, trace=trace)


def reference_frames(config: dict, traffic: dict, seed: int, device, index: int,
                     model: ref.Caddy) -> np.ndarray:
    """The reference's uint8 frames of request ``index``, from its seeded
    observation and actions, with zero variations as the player's."""
    length = (traffic["segment_frames"] if traffic["driver"] == "interactive"
              else traffic["rollout_frames"])
    actions = segment_actions(config, seed, index, length, traffic["hold_mean_frames"])
    observation = torch.from_numpy(videos.start_observation(config, seed, index))
    window = observation.permute(2, 0, 1)[None].to(device)
    eye = torch.eye(model.actions_count, device=device)
    variation = torch.zeros(1, model.action_space_dimension, device=device)
    carry = model.dynamics_network.init_carry(1)
    frames = []
    with torch.no_grad():
        for action in actions:
            carry, frame, window = model.play_step(carry, window, eye[action:action + 1],
                                                   variation)
            frames.append(ref.to_uint8(frame[0]).permute(1, 2, 0).cpu().numpy())
    return np.stack(frames)


def play_gaps(config: dict, traffic: dict, seed: int, device, served: Dict[int, np.ndarray],
              fp8: bool) -> Dict[str, float]:
    """``frame_gap`` (and the mean gap) of the served requests' frames
    against the reference's, the worst frame over all of them."""
    if not served:
        return {"frame_gap": math.inf, "frame_mean_gap": math.inf}
    model = loaded_reference(config, seed, device, ref.Precision(fp8=fp8), vgg=False)[0]
    model.eval()
    with tf32_off():
        gaps = [check.frame_gaps(frames,
                                 reference_frames(config, traffic, seed, device, i, model))
                for i, frames in served.items()]
    return {k: max(g[k] for g in gaps) for k in gaps[0]}


DRIVERS = {"train": _train, "interactive": _play, "rollout": _play}
DRIVER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "drivers")


def load_driver(name: str) -> Callable[[Cell], Outcome]:
    """The built-in driver ``name``, else ``run`` of ``drivers/<name>.py``."""
    if name in DRIVERS:
        return DRIVERS[name]
    path = os.path.join(DRIVER_DIR, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no driver {name!r}: none built in ({', '.join(DRIVERS)}) "
                                f"and no file {path}")
    spec = importlib.util.spec_from_file_location(f"pvg_bench.drivers.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.run


def run(cell: Cell) -> Outcome:
    return load_driver(cell.traffic["driver"])(cell)
