"""The port's host spans (``utils.tracing``) on the CPU: the tallies, the
profiler's events, and the spans at the loader, the training step, the
captured programs and the play session, through the capture stand-in
(``graphs.StandIn``) on tiny models."""
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_parity import single_threaded_torch  # noqa: F401 (an autouse fixture)

from playablevideogeneration_tpu_torch.cli import train as train_cli
from playablevideogeneration_tpu_torch.config.configuration import Configuration
from playablevideogeneration_tpu_torch.data.loader import DataLoader
from playablevideogeneration_tpu_torch.data.synthetic import make_synthetic_config
from playablevideogeneration_tpu_torch.data.video_dataset import SequenceSample
from playablevideogeneration_tpu_torch.inference import graphs
from playablevideogeneration_tpu_torch.inference.play_session import PlaySession
from playablevideogeneration_tpu_torch.models.caddy import make_model
from playablevideogeneration_tpu_torch.tools import profile_step
from playablevideogeneration_tpu_torch.training import bench_harness
from playablevideogeneration_tpu_torch.training.trainer import Trainer
from playablevideogeneration_tpu_torch.utils import tracing

STACKING = 2
SLEEP_S = 0.05


def _tiny_config() -> dict:
    return bench_harness.make_synthetic_config(
        height=32, width=32, actions_count=3, batch_size=2, observations_count=4,
        observation_stacking=STACKING, hidden_state_size=8, state_features=8)


def _trainer() -> Trainer:
    config = _tiny_config()
    trainer = Trainer(config, make_model(config, "cpu", seed=3), smooth_mi=True, seed=4,
                      backend=graphs.StandIn)
    trainer.init_state()
    return trainer


def _batch(seed: int):
    return bench_harness.make_synthetic_batch(
        batch_size=2, observations_count=4, height=32, width=32, actions_count=3,
        observation_stacking=STACKING, seed=seed)


def _session() -> PlaySession:
    session = PlaySession(make_model(_tiny_config(), "cpu", seed=5), backend=graphs.StandIn)
    window = np.random.default_rng(6).uniform(-1, 1, (32, 32, 3 * STACKING))
    return session.start(window.astype(np.float32))


def _since(before: dict) -> dict:
    """The tallies of the spans that ended since ``before`` was taken."""
    return {name: (count - before.get(name, (0, 0.0))[0],
                   seconds - before.get(name, (0, 0.0))[1])
            for name, (count, seconds) in tracing.tallies().items()
            if count != before.get(name, (0, 0.0))[0]}


def _counts(tallies: dict) -> dict:
    return {name: count for name, (count, _) in tallies.items()}


def _port_events(prof) -> list:
    """(name, start s, end s, on the device) of the profiler's ``pvg.`` events."""
    events = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.PREFIX):
            start = e.start_ns() * 1e-9
            events.append((e.name(), start, start + e.duration_ns() * 1e-9,
                           e.device_type() != torch.autograd.DeviceType.CPU))
    return events


def test_a_span_adds_one_and_its_seconds():
    before = tracing.tallies()
    start = time.perf_counter()
    with tracing.span("test.sleep"):
        time.sleep(SLEEP_S)
    elapsed = time.perf_counter() - start
    moved = _since(before)
    assert list(moved) == ["test.sleep"]
    count, seconds = moved["test.sleep"]
    assert count == 1 and SLEEP_S <= seconds <= elapsed
    with tracing.span("test.sleep"):
        pass
    assert tracing.tallies()["test.sleep"][0] == before.get("test.sleep", (0, 0))[0] + 2
    assert tracing.span("test.sleep") is tracing.span("test.sleep")


def test_a_span_records_an_event_only_under_the_profiler():
    with tracing.span("test.unprofiled"):
        torch.ones(2).add_(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(2).add_(1)
    assert _port_events(prof) == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("test.profiled")(step=3):
            torch.ones(2).add_(1)
    assert [(name, device) for name, _, _, device in _port_events(prof)] == [
        ("pvg.test.profiled", False)]


def test_a_train_step_records_its_spans_under_the_profiler():
    """The first step captures its program inside ``train.step``; each
    step's upload, replay, Adam and readback lie inside it."""
    trainer = _trainer()
    for k in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            trainer.train_step(_batch(seed=k))
        events = _port_events(prof)
        assert not any(device for *_, device in events)
        steps = [e for e in events if e[0] == "pvg.train.step"]
        assert len(steps) == 1
        _, start, end, _ = steps[0]
        inner = sorted(name for name, s, e, _ in events
                       if name != "pvg.train.step" and start <= s <= e <= end)
        want = ["pvg.program.replay", "pvg.train.optimizer", "pvg.train.readback",
                "pvg.train.upload"]
        assert inner == sorted(want + (["pvg.program.capture"] if k == 0 else []))
        assert len(events) == len(inner) + 1


def test_a_play_session_counts_its_calls_replays_and_readbacks():
    session = _session()
    before = tracing.tallies()
    frames = [session.generate_next_u8(action) for action in (0, 2, 1)]
    assert all(f.dtype == np.uint8 and f.shape == (32, 32, 3) for f in frames)
    assert _counts(_since(before)) == {
        "play.call": 3, "play.readback": 3, "program.replay": 3, "program.capture": 1}
    before = tracing.tallies()
    session.rollout(np.array([0, 1]))
    session.generate_next_u8(1, block=False)
    assert _counts(_since(before)) == {
        "play.call": 2, "play.readback": 1, "program.replay": 2, "program.capture": 1}


@pytest.mark.parametrize("route", ["train", "play"])
def test_no_span_fires_inside_a_captured_function(route):
    """A route's first call differs from the next by its capture alone: the
    captured function, which the capture runs three times, fires no span."""
    if route == "train":
        trainer = _trainer()
        calls = [lambda k=k: trainer.train_step(_batch(seed=k)) for k in range(2)]
    else:
        session = _session()
        calls = [lambda a=a: session.generate_next(a) for a in (0, 1)]
    moved = []
    for call in calls:
        before = tracing.tallies()
        call()
        moved.append(_counts(_since(before)))
    assert moved[0] == dict(moved[1], **{"program.capture": 1})


def test_a_capture_counts_the_same_whatever_its_function_runs():
    session = _session()
    state = session._state()
    values = [session._onehot(0), session._variations(1)]
    before = tracing.tallies()
    graphs.Program(lambda *tensors: (tensors[:len(state)], tensors[-1] + 1), state,
                   [v.clone() for v in values], session.model, graphs.StandIn)
    trivial = _counts(_since(before))
    before = tracing.tallies()
    graphs.Program(session._step, state, [v.clone() for v in values], session.model,
                   graphs.StandIn)
    assert _counts(_since(before)) == trivial == {"program.capture": 1}


class _Items:
    """``count`` one-frame samples, each ``delay_s`` in the making."""

    def __init__(self, count: int, delay_s: float):
        self.count, self.delay_s = count, delay_s

    def __len__(self):
        return self.count

    def __getitem__(self, index):
        time.sleep(self.delay_s)
        return SequenceSample(observations=np.full((1, 2, 2, 3), index, np.float32),
                              actions=np.zeros(1, np.int32), rewards=np.zeros(1, np.float32),
                              dones=np.zeros(1, bool), video=None, initial_frame_index=index)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_the_loader_counts_one_get_per_batch(mode):
    loader = DataLoader(_Items(6, 0.0), batch_size=2, shuffle=False, num_workers=2,
                        worker_mode=mode)
    before = tracing.tallies()
    batches = list(loader)
    assert [b.initial_frames for b in batches] == [[0, 1], [2, 3], [4, 5]]
    assert _counts(_since(before)) == {"loader.get": 3}


def test_the_loader_span_holds_the_consumers_wait():
    """One worker making a batch in SLEEP_S: the consumer, which takes each
    batch at once, waits for nearly all of them inside ``loader.get``."""
    count = 6
    loader = DataLoader(_Items(count, SLEEP_S), batch_size=1, shuffle=False, num_workers=1,
                        prefetch=1)
    before = tracing.tallies()
    assert len(list(loader)) == count
    _, seconds = _since(before)["loader.get"]
    assert seconds >= 0.8 * count * SLEEP_S


def test_the_loader_span_stays_near_zero_behind_a_slow_consumer():
    count = 6
    loader = DataLoader(_Items(count, 0.0), batch_size=1, shuffle=False, num_workers=2,
                        prefetch=2)
    before = tracing.tallies()
    for _ in loader:
        time.sleep(2 * SLEEP_S)
    _, seconds = _since(before)["loader.get"]
    assert seconds < 0.1 * count * SLEEP_S


def test_the_operators_profiler_trace_names_the_train_step(synthetic_dataset_dir, tmp_path):
    """``tpu.profile_dir``'s Chrome trace of the epoch's window holds the
    port's spans as host operators, which ``tools/profile_step.py``'s host
    tables leave out."""
    config = make_synthetic_config(
        data_root=synthetic_dataset_dir, output_root=str(tmp_path / "out"), height=32,
        width=32, actions_count=3, batch_size=2, observations_count=4, observation_stacking=1,
        hidden_state_size=8, state_features=8, pretraining_steps=1, max_steps=5)
    configuration = Configuration(config=config)
    configuration.check_config()
    configuration.create_directory_structure()
    config["training"]["batching"]["observations_count_start"] = 4
    config["tpu"]["profile_dir"] = str(tmp_path / "trace")
    _, _, trainer, _, _ = train_cli.build_run(config, device="cpu")
    trainer.init_state()
    trainer.train_epoch(max_steps=5)
    [name] = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name", "").startswith(tracing.PREFIX)]
    assert {e["name"] for e in spans} >= {"pvg.train.step", "pvg.train.upload",
                                          "pvg.train.optimizer", "pvg.train.readback",
                                          "pvg.loader.get"}
    assert {e["cat"] for e in spans} == {"cpu_op"}
    # The step profiler's host tables count operators, not the port's spans.
    rows = profile_step.analyze(str(tmp_path / "trace" / name))["rows"]
    assert rows and not any(r["name"].startswith(tracing.PREFIX) for r in rows)
