"""The port's training CLI on the CPU: ``cli.train.train`` over a synthetic
dataset at tiny widths, against the JAX trainer's host schedules, with
checkpoints, resume and the three evaluation passes; ``main``; and the
whole loop with Pillow and PyYAML unavailable, as on the machine with the
card.
"""
import os
import subprocess
import sys
import textwrap
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml
from torch_parity import single_threaded_torch  # noqa: F401 (an autouse fixture)

from playablevideogeneration_tpu.training.trainer import Trainer as JaxTrainer
from playablevideogeneration_tpu_torch.cli import train as train_cli
from playablevideogeneration_tpu_torch.config.configuration import Configuration
from playablevideogeneration_tpu_torch.data.synthetic import make_synthetic_config
from playablevideogeneration_tpu_torch.evaluation.evaluator import Evaluator
from playablevideogeneration_tpu_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(data_root, output_root, overrides=()):
    """Tiny widths; the sequence length grows 3 -> 4 at step 2, so the
    first epoch ends there; evaluation after step 3, with all three
    passes."""
    config = make_synthetic_config(
        data_root=data_root, output_root=output_root, height=32, width=32, actions_count=3,
        batch_size=2, observations_count=4, observation_stacking=1, hidden_state_size=8,
        state_features=8, pretraining_steps=1, max_steps=3)
    batching = config["training"]["batching"]
    batching["observations_count_start"] = 3
    batching["observations_count_steps"] = 2
    config["training"]["save_freq"] = 2
    config["evaluation"]["eval_freq"] = 3
    config["evaluation"]["batching"]["observations_count"] = 4
    for (section, key), value in dict(overrides).items():
        config[section][key] = value
    c = Configuration(config=config)
    c.check_config()
    c.create_directory_structure()
    return config


@pytest.fixture
def recorded(monkeypatch):
    """Every train step's (global step, metrics) and every evaluation's
    (sampler label, metrics)."""
    steps, evaluations = [], []
    train_step, evaluate = Trainer.train_step, Evaluator.evaluate

    def record_step(self, batch):
        metrics = train_step(self, batch)
        steps.append((self.global_step, dict(metrics)))
        return metrics

    def record_evaluation(self, *args, **kwargs):
        metrics = evaluate(self, *args, **kwargs)
        evaluations.append((self._sampler_label, metrics))
        return metrics

    monkeypatch.setattr(Trainer, "train_step", record_step)
    monkeypatch.setattr(Evaluator, "evaluate", record_evaluation)
    return SimpleNamespace(steps=steps, evaluations=evaluations)


def _assert_states_equal(got, want):
    got_model, want_model = got.model.state_dict(), want.model.state_dict()
    assert list(got_model) == list(want_model)
    for key in want_model:
        assert torch.equal(got_model[key], want_model[key]), key
    got_opt, want_opt = got.state.optimizer.state_dict(), want.state.optimizer.state_dict()
    assert got_opt["param_groups"] == want_opt["param_groups"]
    assert sorted(got_opt["state"]) == sorted(want_opt["state"])
    for index, slots in want_opt["state"].items():
        for name, value in slots.items():
            assert torch.equal(got_opt["state"][index][name], value), (index, name)
    assert got.state.scheduler.state_dict() == want.state.scheduler.state_dict()
    assert torch.equal(got.state.mi_matrix, want.state.mi_matrix)
    assert got.state.step == want.state.step
    assert got.global_step == want.global_step


def test_train_schedules_checkpoints_resume_and_evaluation(synthetic_dataset_dir, tmp_path,
                                                           recorded, capsys):
    config = _config(synthetic_dataset_dir, str(tmp_path))
    trainer = train_cli.train(config, max_steps=3, device="cpu")
    assert trainer.global_step == 3 and trainer.state.step == 3
    assert trainer.model.training

    # Step 2 ends the first epoch untaken: the sequence length changes there.
    assert [s for s, _ in recorded.steps] == [1, 3]
    t = config["training"]
    for step, metrics in recorded.steps:
        reference = SimpleNamespace(config=config, global_step=step)
        length = JaxTrainer.get_observations_count(reference)
        assert metrics["observations_count"] == length
        assert metrics["ground_truth_observations"] == min(
            JaxTrainer.get_ground_truth_observations_count(reference), length - 1)
        assert metrics["gumbel_temperature"] == JaxTrainer.get_gumbel_temperature(reference)
        assert metrics["pretraining"] == float(step <= t["pretraining_steps"])
        assert np.isfinite(metrics["loss"])
    assert [m["observations_count"] for _, m in recorded.steps] == [3, 4]

    save_root = config["logging"]["save_root_directory"]
    assert sorted(os.listdir(save_root)) == ["checkpoint_2", "latest"]

    # The cli's three passes, as tests/test_train_e2e.py asserts for JAX.
    assert [label for label, _ in recorded.evaluations] == [None, "one_hot", "gt_actions"]
    default, one_hot, gt = (m for _, m in recorded.evaluations)
    for metrics in (default, one_hot, gt):
        assert metrics and all(np.isfinite(v) for v in metrics.values())
    assert one_hot["validation/one_hot/samples_entropy"] < 1e-5
    assert default["validation/samples_entropy"] > 1e-3
    assert gt["validation/gt_actions/actions_accuracy"] > 0.999
    assert os.path.isfile(os.path.join(config["logging"]["output_images_directory"],
                                       "validation_observations_3.png"))

    # A fresh run restores every tensor and the step exactly.
    _, _, restored, _, _ = train_cli.build_run(config, device="cpu")
    restored.init_state()
    restored.load_checkpoint()
    _assert_states_equal(restored, trainer)

    capsys.readouterr()
    resumed = train_cli.train(config, max_steps=4, device="cpu")
    assert "- Resuming from checkpoint" in capsys.readouterr().out
    assert resumed.global_step == 4
    assert [s for s, _ in recorded.steps] == [1, 3, 4]


def test_train_epoch_caps_steps_per_epoch(synthetic_dataset_dir, tmp_path, recorded):
    """The reference's epoch cap ``performed_steps > max_steps_per_epoch``
    lets one step more than the cap through."""
    config = _config(synthetic_dataset_dir, str(tmp_path),
                     {("training", "max_steps_per_epoch"): 1})
    config["training"]["batching"]["observations_count_start"] = 4
    _, _, trainer, _, _ = train_cli.build_run(config, device="cpu")
    trainer.init_state()
    trainer.train_epoch()
    assert trainer.global_step == 2
    bare = Trainer(config, trainer.model, vgg=trainer.vgg)
    bare.init_state()
    with pytest.raises(RuntimeError, match="without a dataset"):
        bare.train_epoch()


def test_main_trains_resumes_and_needs_a_gpu_by_default(synthetic_dataset_dir, tmp_path,
                                                        monkeypatch, capsys):
    config = _config(synthetic_dataset_dir, str(tmp_path / "out"),
                     {("evaluation", "eval_freq"): 0})
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(config))
    monkeypatch.setattr(sys, "argv", ["train", "--config", str(path), "--device", "cpu"])
    train_cli.main()
    out = capsys.readouterr().out
    assert "No checkpoint found" in out and "Training complete" in out
    assert os.path.isdir(os.path.join(config["logging"]["save_root_directory"], "latest"))
    train_cli.main()
    assert "- Resuming from checkpoint" in capsys.readouterr().out

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["train", "--config", str(path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main()


def test_loop_needs_neither_pillow_nor_yaml():
    """With PIL, yaml, jax, flax and the JAX package blocked: every module
    of the port and chip_smoke.py import, and the training loop with its
    evaluation runs on videos held in memory, as chip_smoke.py runs it."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys, tempfile
        BLOCKED = {"PIL", "yaml", "jax", "jaxlib", "flax", "playablevideogeneration_tpu"}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import playablevideogeneration_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        import chip_smoke
        from playablevideogeneration_tpu_torch.cli.train import train
        from playablevideogeneration_tpu_torch.config.configuration import Configuration
        from playablevideogeneration_tpu_torch.data.synthetic import (
            make_moving_square_video, make_synthetic_config)
        from playablevideogeneration_tpu_torch.data.transforms import get_final_transforms
        from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset

        root = tempfile.mkdtemp()
        config = make_synthetic_config(
            data_root=root + "/none", output_root=root, height=32, width=32, actions_count=3,
            batch_size=2, observations_count=4, observation_stacking=1, hidden_state_size=8,
            state_features=8, pretraining_steps=1, max_steps=2)
        config["evaluation"]["eval_freq"] = 2
        Configuration(config=config).check_config(check_data_root=False)
        config["logging"]["output_images_directory"] = None
        transforms = get_final_transforms(config)
        batching = {"train": config["training"]["batching"],
                    "validation": config["evaluation"]["batching"],
                    "test": config["evaluation"]["batching"]}
        datasets = {name: VideoDataset.from_videos(
                        [make_moving_square_video(12, 32, 32, seed=seed + 10 * i)
                         for seed in range(2)], batching[name], transforms[name])
                    for i, name in enumerate(batching)}
        trainer = train(config, device="cpu", datasets=datasets)
        assert trainer.global_step == 2, trainer.global_step
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not leaked, leaked
        print("LOOP_OK")
    """)
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                            text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert result.returncode == 0, result.stderr[-3000:]
    assert "LOOP_OK" in result.stdout
    assert "== Evaluation [2][validation] ==" in result.stdout


def test_chip_smoke_launch_counts_are_the_models(monkeypatch):
    """``chip_smoke.py`` requires exact kernel launch counts in phase 10;
    the CPU runs the plain versions, here counted where the model calls the
    kernels' wrappers: an evaluation forward of the flagship (eval mode,
    one ground-truth frame) calls K3 at exactly ``eval_norm_shapes`` and K1
    3(T-1) times, a train step K1 and K2 3(T-1) times each and K3 never."""
    import chip_smoke
    from playablevideogeneration_tpu_torch.evaluation.action_sampler import (
        one_hot_action_sampler,
    )
    from playablevideogeneration_tpu_torch.models import layers
    from playablevideogeneration_tpu_torch.models.caddy import flagship_model
    from playablevideogeneration_tpu_torch.ops.cuda import convlstm_gates
    from playablevideogeneration_tpu_torch.training.bench_harness import (
        build_synthetic_trainer,
        make_synthetic_batch,
    )

    calls = {"gates": 0, "gates_bwd": 0, "norm": []}

    def counted(name, fn):
        def wrapped(*args):
            calls[name] = (calls[name] + [tuple(args[0].shape)] if name == "norm"
                           else calls[name] + 1)
            return fn(*args)
        return wrapped

    monkeypatch.setattr(layers, "fused_lstm_gates", counted("gates", layers.fused_lstm_gates))
    monkeypatch.setattr(layers, "fused_batch_norm_leaky_relu",
                        counted("norm", layers.fused_batch_norm_leaky_relu))
    monkeypatch.setattr(convlstm_gates, "fused_lstm_gates_bwd",
                        counted("gates_bwd", convlstm_gates.fused_lstm_gates_bwd))

    batch, frames = 1, 3
    model = flagship_model(device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    observations = torch.from_numpy(
        rng.uniform(-1, 1, (batch, frames, 3, 256, 256)).astype(np.float32))
    actions = torch.from_numpy(rng.integers(0, 7, (batch, frames)))
    with torch.no_grad():
        model(observations, actions, 1, generator=torch.Generator(),
              gumbel_temperature=0.4, action_sampler=one_hot_action_sampler)
    assert Counter(calls["norm"]) == Counter(chip_smoke.eval_norm_shapes(batch, frames))
    assert calls["gates"] == 3 * (frames - 1) and calls["gates_bwd"] == 0

    calls.update(gates=0, norm=[])
    trainer = build_synthetic_trainer(height=32, width=32, batch_size=2, observations_count=4,
                                      hidden_state_size=8, state_features=8, remat=False,
                                      compute_dtype="float32", pretraining_steps=1,
                                      device="cpu")
    for _ in range(2):  # a pretraining step, then a full-phase one
        calls.update(gates=0, gates_bwd=0)
        trainer.train_step(make_synthetic_batch(batch_size=2, observations_count=4,
                                                height=32, width=32))
        assert calls["gates"] == calls["gates_bwd"] == 3 * (4 - 1)
    assert calls["norm"] == []


def test_grad_histograms_profiler_window_and_plots(synthetic_dataset_dir, tmp_path):
    """``tpu.grad_histograms``: 64-bin (counts, edges) per subnetwork of
    the gradients; ``tpu.profile_dir``: a Chrome
    trace of the epoch's window; the action-space plots every
    ``action_direction_plotting_freq`` steps."""
    config = _config(synthetic_dataset_dir, str(tmp_path / "out"),
                     {("training", "action_direction_plotting_freq"): 2})
    config["training"]["batching"]["observations_count_start"] = 4
    config["tpu"].update(grad_histograms=True, profile_dir=str(tmp_path / "trace"))
    _, _, trainer, _, _ = train_cli.build_run(config, device="cpu")
    trainer.init_state()
    batch = next(iter(trainer.dataloader))
    metrics = trainer.train_step(batch)
    modules = {name.split(".")[0] for name, _ in trainer.model.named_parameters()}
    assert {k for k in metrics if k.startswith("_grad_hist/")} == {
        f"_grad_hist/{m}" for m in modules}
    grads = {m: [] for m in modules}
    for name, p in trainer.model.named_parameters():
        grads[name.split(".")[0]].append(p.grad.flatten())
    for module, values in grads.items():
        values = torch.cat(values).numpy()
        counts, edges = metrics[f"_grad_hist/{module}"]
        assert counts.shape == (64,) and edges.shape == (65,)
        assert counts.sum() == values.size
        lo, hi = values.min(), values.max()
        np.testing.assert_allclose(edges, lo + (hi - lo) * np.linspace(0, 1, 65), rtol=0,
                                   atol=1e-6 * (hi - lo))
        # np.histogram's half-open bins, the last value clamped into bin 63.
        index = np.clip(np.searchsorted(edges, values, side="right") - 1, 0, 63)
        np.testing.assert_array_equal(counts, np.bincount(index, minlength=64))

    trainer.train_epoch(max_steps=5)
    assert trainer.global_step == 5
    assert os.listdir(tmp_path / "trace") == ["trace_5.json"]
    images = config["logging"]["output_images_directory"]
    assert {"action_directions_2.png", "action_states_4.png"} <= set(os.listdir(images))
