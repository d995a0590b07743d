"""A run with its timed path broken underneath comes out not correct, and so
does the control (the reference in fp8 in the program's place); a sound run
comes out correct.  At a tiny size on the CPU, against the cells' limits;
the look for a card is skipped (``drive.run`` is the rest of a run)."""
import dataclasses

import numpy as np
import pytest
import torch

from pvg_bench import check, control, drive
from pvg_bench.tests.tiny import tiny_cell


def _correct(cell) -> bool:
    return check.passed(drive.run(cell).checks)


@pytest.mark.parametrize("workload", ["bair.train", "tennis.train", "bair.play", "bair.rollout"])
def test_sound_run_is_correct(workload):
    assert _correct(tiny_cell(workload))


def test_step_that_leaves_the_state_unchanged(monkeypatch):
    from playablevideogeneration_tpu_torch.training.trainer import Trainer

    step = Trainer.train_step

    def unchanged(self, batch):
        before = [p.detach().clone() for p in self.model.parameters()]
        metrics = step(self, batch)
        with torch.no_grad():
            for p, b in zip(self.model.parameters(), before):
                p.copy_(b)
        return metrics
    monkeypatch.setattr(Trainer, "train_step", unchanged)
    assert not _correct(tiny_cell("bair.train"))


def test_half_of_the_batch_left_out(monkeypatch):
    from playablevideogeneration_tpu_torch.training.trainer import Trainer

    step = Trainer.train_step

    def half(self, batch):
        rows = len(batch.observations) // 2
        return step(self, dataclasses.replace(batch, observations=batch.observations[:rows],
                                              actions=batch.actions[:rows]))
    monkeypatch.setattr(Trainer, "train_step", half)
    assert not _correct(tiny_cell("bair.train"))


def test_update_of_the_wrong_sign(monkeypatch):
    from playablevideogeneration_tpu_torch.training.trainer import Trainer

    step = Trainer.train_step

    def reversed_(self, batch):
        before = [p.detach().clone() for p in self.model.parameters()]
        metrics = step(self, batch)
        with torch.no_grad():
            for p, b in zip(self.model.parameters(), before):
                p.copy_(2 * b - p)
        return metrics
    monkeypatch.setattr(Trainer, "train_step", reversed_)
    assert not _correct(tiny_cell("bair.train"))


def _altered(frame: np.ndarray) -> np.ndarray:
    frame = frame.copy()
    frame[: len(frame) // 2] = 255 - frame[: len(frame) // 2]
    return frame


def test_frame_altered_where_it_is_produced(monkeypatch):
    from playablevideogeneration_tpu_torch.inference.play_session import PlaySession

    generate, calls = PlaySession.generate_next_u8, [0]

    def altered(self, action, block=True):
        calls[0] += 1
        frame = generate(self, action, block)
        return _altered(frame) if calls[0] % 5 == 0 else frame
    monkeypatch.setattr(PlaySession, "generate_next_u8", altered)
    assert not _correct(tiny_cell("bair.play"))


def test_rollout_frame_altered_where_it_is_produced(monkeypatch):
    from playablevideogeneration_tpu_torch.inference.play_session import PlaySession

    rollout = PlaySession.rollout

    def altered(self, actions):
        frames = rollout(self, actions)
        frames[2] = _altered(frames[2])
        return frames
    monkeypatch.setattr(PlaySession, "rollout", altered)
    assert not _correct(tiny_cell("bair.rollout"))


@pytest.mark.parametrize("workload", ["bair.train", "tennis.train", "bair.play", "bair.rollout"])
def test_control_is_not_correct(workload):
    cell = tiny_cell(workload)
    numbers, _ = control.control_numbers(cell, "control")
    assert not check.passed(check.judged(numbers, cell.limits))


def test_update_norm_gap_compares_the_norms_of_the_changes(monkeypatch):
    # Adam's first updates are nearly lr * sign(gradient): two runs whose
    # changes differ in sign element by element, but not in size, agree;
    # a state left unchanged reads 1 at the median leaf.
    start = {"a": torch.zeros(4), "b": torch.zeros(4), "c": torch.zeros(4),
             "bn.running_mean": torch.zeros(2), "centroids": torch.zeros(2)}
    step = {"a": torch.tensor([1.0, -1, 1, -1]), "b": torch.tensor([2.0, 2, -2, 2]),
            "c": torch.tensor([-3.0, 3, 3, 3])}
    buffers = {"bn.running_mean": torch.ones(2), "centroids": torch.ones(2)}
    run = dict(losses=[1.0], first_gradients=step, first_buffers=buffers, parameters=step)
    monkeypatch.setattr(drive, "program_weights", lambda *a, **k: [start])
    cpu = torch.device("cpu")
    flipped, _ = drive.compare_training(dict(run, parameters={n: -t for n, t in step.items()}),
                                        run, {}, 0, cpu)
    unchanged, _ = drive.compare_training(dict(run, parameters=start), run, {}, 0, cpu)
    assert flipped["update_norm_gap"] == 0.0
    assert unchanged["update_norm_gap"] == 1.0


def test_descent_gap_sees_the_direction_of_the_change(monkeypatch):
    start = {n: torch.zeros(4) for n in "abc"}
    start.update({"bn.running_mean": torch.zeros(2), "centroids": torch.zeros(2)})
    gradient = {"a": torch.tensor([1.0, -2, 3, -4]), "b": torch.tensor([0.5, 0.5, -1, 1]),
                "c": torch.tensor([-3.0, 1, 1, 2])}
    step = {n: -0.01 * torch.sign(g) for n, g in gradient.items()}
    buffers = {"bn.running_mean": torch.ones(2), "centroids": torch.ones(2)}
    run = dict(losses=[1.0], first_gradients=gradient, first_buffers=buffers, parameters=step)
    monkeypatch.setattr(drive, "program_weights", lambda *a, **k: [start])
    cpu = torch.device("cpu")

    def gap(parameters):
        return drive.compare_training(dict(run, parameters=parameters), run, {}, 0, cpu)[0][
            "descent_gap"]
    assert gap(step) == 0.0
    assert gap({n: -t for n, t in step.items()}) == pytest.approx(2.0)
    assert gap({n: 2 * t for n, t in step.items()}) == pytest.approx(1.0)
    assert gap(start) == pytest.approx(1.0)


@pytest.mark.parametrize("workload,what", [("bair.train", "program"), ("bair.train", "control"),
                                           ("tennis.train", "half_batch"),
                                           ("bair.rollout", "control")])
def test_control_main_at_a_tiny_size(monkeypatch, capsys, workload, what):
    import json

    monkeypatch.setattr(control.spec, "cell",
                        lambda name, seed, seconds, trace, device: tiny_cell(name, seed))
    assert control.main(["--workload", workload, "--what", what, "--seeds", "11,12",
                         "--device", "cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["seed"] for line in lines[:2]] == [11, 12]
    summary = lines[2]
    number = "frame_gap" if workload == "bair.rollout" else "descent_gap"
    assert summary[f"{number}_max"] == max(line[number] for line in lines[:2])
