"""The port's step profiler, input-pipeline bench and CLI soak on the CPU,
against the JAX package's tools (``tools/profile_step.py``,
``tools/bench_input_pipeline.py``, ``tools/tpu_soak.py``): the soak's
configs, videos, weight files, stage commands and validation; the scope
labels; the trace analysis on a hand-written trace and on a real CPU
profile; the bench's JSON keys.  Configs, videos and argument lists must
be equal; weight files equal in keys, shapes and dtypes (their values are
drawn by each framework's own initialisers).
"""
import ast
import contextlib
import io
import json
import os
import sys
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch
import yaml
from torch_parity import single_threaded_torch  # noqa: F401 (an autouse fixture)

import tools.bench_input_pipeline as jax_bench
import tools.tpu_soak as jax_soak
from playablevideogeneration_tpu.evaluation.metrics import i3d as jax_i3d
from playablevideogeneration_tpu.evaluation.metrics import inception as jax_inception
from playablevideogeneration_tpu.models import vgg as jax_vgg
from playablevideogeneration_tpu_torch.tools import bench_input_pipeline, gpu_soak, profile_step
from playablevideogeneration_tpu_torch.training.bench_harness import build_synthetic_trainer
from playablevideogeneration_tpu_torch.utils import pretrained

with mock.patch.dict(os.environ):  # the JAX tool sets a compile cache on import
    import tools.profile_step as jax_profile

REPO = Path(__file__).resolve().parents[1]
JAX_CLI, PORT_CLI = "playablevideogeneration_tpu.cli.", "playablevideogeneration_tpu_torch.cli."


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_fixture_config_and_videos_match_the_jax_tool(tmp_path):
    """Both fixtures in one root: the same config once loaded, and the same
    bytes in every file of the synthetic splits (PNG frames and pickles)."""
    root = str(tmp_path / "soak")
    with open(jax_soak.build_fixture(root)) as f:
        want_config = yaml.safe_load(f)
    want_files = _files(tmp_path / "soak" / "data")
    with open(gpu_soak.build_fixture(root)) as f:
        got_config = yaml.safe_load(f)
    assert got_config == want_config
    got_files = _files(tmp_path / "soak" / "data")
    assert len(got_files) == len(want_files) > 3 * 2 * 12
    assert got_files == want_files


def test_eval_config_matches_the_jax_tool(tmp_path):
    with open(jax_soak.build_eval_config(str(tmp_path))) as f:
        want = yaml.safe_load(f)
    with open(gpu_soak.build_eval_config(str(tmp_path))) as f:
        got = yaml.safe_load(f)
    assert got == want


def _shapes_only(init):
    """A JAX initialiser that returns zeros of the shapes and dtypes that
    ``init`` gives, traced without running it (the full one takes minutes on
    the CPU)."""
    def shaped(key):
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(init, key))
    return shaped


def test_random_weight_files_match_the_jax_tool(tmp_path, monkeypatch):
    for module, name in ((jax_vgg, "random_vgg_variables"),
                         (jax_inception, "random_inception_variables"),
                         (jax_i3d, "random_i3d_variables")):
        monkeypatch.setattr(module, name, _shapes_only(getattr(module, name)))
    jax_soak.build_random_backbone_weights(str(tmp_path / "jax"))
    gpu_soak.build_random_backbone_weights(str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names == sorted(
        pretrained.WEIGHT_FILES[k] for k in ("vgg19", "fid_inception", "i3d", "lpips_lin"))
    for name in names:
        with np.load(tmp_path / "jax" / name) as want, np.load(tmp_path / "port" / name) as got:
            assert sorted(got.files) == sorted(want.files), name
            for key in want.files:
                assert (got[key].shape, got[key].dtype) == (want[key].shape, want[key].dtype), key
            if name == "lpips_lin.npz":  # both drawn from numpy's generator, seed 0
                for key in want.files:
                    np.testing.assert_array_equal(got[key], want[key])
    # The port resolves and loads every backbone from the directory.
    config = {"tpu": {"pretrained_weights_dir": str(tmp_path / "port")},
              "evaluation": {"compute_inception_score": True}}
    found = pretrained.evaluation_backbones(config, device="cpu")
    assert all(value is not None for value in found.values()), found


class _Stop(Exception):
    pass


def test_stage_commands_match_the_jax_tool(tmp_path, monkeypatch):
    """The JAX tool's five commands, recorded in place of running them, are
    the port's with the package name swapped and ``--device`` added."""
    recorded = []

    def record(name, argv, env, log_dir, timeout=1800):
        recorded.append((name, argv, env["PVG_PRETRAINED_WEIGHTS"]))
        if name == "evaluate_dataset":
            raise _Stop
        return 0.0

    root = str(tmp_path / "soak")
    monkeypatch.setattr(jax_soak, "run_stage", record)
    monkeypatch.setattr(jax_soak, "build_random_backbone_weights", lambda directory: None)
    monkeypatch.setattr(sys, "argv", ["tpu_soak.py", "--root", root])
    with pytest.raises(_Stop):
        jax_soak.main()
    got = gpu_soak.stage_argvs(root + "/config.yaml", root + "/eval_config.yaml", "cpu")
    assert [gpu_soak.LOG_NAMES.get(n, n) for n in got] == [r[0] for r in recorded]
    for argv, (_, want, weights) in zip(got.values(), recorded):
        assert weights == root + "/weights"
        assert argv == [w.replace(JAX_CLI, PORT_CLI) for w in want] + ["--device", "cpu"]
    assert gpu_soak.parse_args([]).device == "cuda"


def _jax_required_families() -> list:
    """The ``required`` list of the JAX tool's validation, read from its
    source (it is local to ``main``)."""
    tree = ast.parse((REPO / "tools" / "tpu_soak.py").read_text())
    return next(ast.literal_eval(node.value) for node in ast.walk(tree)
                if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "required")


def test_cpu_soak_runs_train_resume_play(tmp_path, monkeypatch):
    """The first three stages as processes on the CPU at the fixture's
    size; the second train stage resumes from the first's checkpoint."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = tmp_path / "soak"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        summary = gpu_soak.main(["--root", str(root), "--device", "cpu", "--stages",
                                 "train,resume,play"])
    assert "[gpu_soak] PASS (partial)" in printed.getvalue()
    assert list(summary["stage_seconds"]) == ["train", "resume", "play"]
    assert "Resuming" in (root / "logs" / "resume.log").read_text()


@pytest.mark.slow  # about 120 s on one thread per stage, evaluate_dataset half of it
def test_cpu_soak_passes_the_jax_validation(tmp_path, monkeypatch):
    """All five stages as processes on the CPU at the fixture's size: every
    required family finite, no marker; the JAX tool's checks agree."""
    # One thread per stage, as single_threaded_torch gives this process.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = tmp_path / "soak"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        summary = gpu_soak.main(["--root", str(root), "--device", "cpu"])
    assert "[gpu_soak] PASS: full pipeline executed on cpu" in printed.getvalue()
    assert list(summary["stage_seconds"]) == list(gpu_soak.STAGES)
    assert gpu_soak.REQUIRED == _jax_required_families()
    with open(root / "out/evaluation_results/synthetic/data.yml") as f:
        metrics = yaml.safe_load(f)
    assert all(k in metrics for k in gpu_soak.REQUIRED)
    assert not [k for k in metrics if k.endswith("_unavailable")]
    assert all(np.isfinite(v) for v in metrics.values() if isinstance(v, float))
    assert summary["missing_families"] == summary["unavailable_markers"] == summary[
        "nonfinite"] == []
    # The run resumed from the first train stage's checkpoint.
    assert "Resuming" in (root / "logs" / "resume.log").read_text()


def _valid_metrics() -> dict:
    return {k: 1.0 for k in gpu_soak.REQUIRED}


@pytest.mark.parametrize("break_metrics", [
    # What the evaluation writes where scikit-learn is not installed.
    lambda m: {**{k: v for k, v in m.items() if not k.startswith("action_classification")},
               "action_classification_unavailable": "scikit-learn not installed"},
    lambda m: {**m, "lpips_unavailable": "no weights"},
    lambda m: {**m, "fid": float("nan")},
    lambda m: {k: v for k, v in m.items() if k != "fvd"},
], ids=["no_sklearn", "marker", "nonfinite", "missing"])
def test_validation_fails_as_the_jax_tool_does(break_metrics):
    """Every required family, finite, no marker: the JAX tool's checks,
    with no family exempted."""
    assert gpu_soak.REQUIRED == _jax_required_families()
    assert not any(gpu_soak.validate(_valid_metrics()).values())
    assert any(gpu_soak.validate(break_metrics(_valid_metrics())).values())


def test_the_soak_exits_1_without_a_required_family(tmp_path, monkeypatch):
    """``data.yml`` without the SVM accuracy and with its marker, as a
    machine without scikit-learn writes it: the soak exits 1."""
    root = tmp_path / "soak"
    monkeypatch.setattr(gpu_soak, "run_stage", lambda *args, **kwargs: 0.0)
    monkeypatch.setattr(gpu_soak, "build_random_backbone_weights", lambda directory: None)
    results = root / "out/evaluation_results/synthetic"
    results.mkdir(parents=True)
    metrics = {k: v for k, v in _valid_metrics().items()
               if not k.startswith("action_classification")}
    metrics["action_classification_unavailable"] = "scikit-learn not installed"
    (results / "data.yml").write_text(yaml.safe_dump(metrics))
    with pytest.raises(SystemExit) as exit_info, contextlib.redirect_stdout(io.StringIO()):
        gpu_soak.main(["--root", str(root), "--keep-fixture", "--device", "cpu"])
    assert exit_info.value.code == 1


def test_a_failing_stage_exits_1(tmp_path):
    with pytest.raises(SystemExit) as exit_info:
        gpu_soak.run_stage("broken", [sys.executable, "-c", "raise SystemExit(3)"], dict(
            os.environ), str(tmp_path))
    assert exit_info.value.code == 1


@pytest.mark.parametrize("name", [
    "model.representation_network", "model.dynamics_network", "model.rendering_network",
    "model.action_network_0", "model.action_network_3", "vgg", "optimizer",
    "model.state_to_hidden", "Optimizer.step#Adam.step", "aten::copy_", ""])
def test_scope_labels_match_the_jax_tool(name):
    assert profile_step.classify_scope(name) == jax_profile.classify_scope(name)


def test_the_scoped_modules_take_the_jax_labels():
    trainer = build_synthetic_trainer(height=32, width=32, batch_size=2, observations_count=4,
                                      hidden_state_size=8, state_features=8, device="cpu")
    labels = {name: profile_step.classify_scope(name)
              for name, _ in profile_step.ScopeRanges(trainer).modules}
    assert labels == {"model.representation_network": "representation (encoder)",
                      "model.dynamics_network": "dynamics (convlstm hourglass)",
                      "model.rendering_network": "rendering (decoder)",
                      "model.action_network_0": "action network", "vgg": "vgg (perceptual)"}
    assert profile_step.classify_scope("optimizer") == "optimizer/adam"


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _hand_written_trace() -> list:
    """Two steps on a forward thread (tid 10, the profiler's thread 1) and
    the autograd engine's thread (tid 20, thread 2), and the device:

    - a forward conv (sequence 7) and a launch straight from the range in
      ``scope:model.dynamics_network``;
    - a backward op of sequence 7 and one of sequence 8 from thread 1;
    - a recompute on the engine's thread in ``scope:model.rendering_network``
      (sequence 1 of thread 2), and a backward op of that node;
    - a launch from the loss, outside every scope;
    - a memcpy in ``scope:optimizer``;
    - a kernel whose launch was not recorded, found by its External id."""
    step, fwd, eng = profile_step.STEP_RANGE, {"Fwd thread id": 0}, 2
    host = [
        _x("user_annotation", step, 10, 0, 1000),
        _x("user_annotation", step, 10, 1000, 1000),
        _x("user_annotation", "scope:model.dynamics_network", 10, 10, 100),
        _x("cpu_op", "aten::convolution", 10, 20, 30, **{"Sequence number": 7,
                                                          "External id": 3}, **fwd),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 30, 5, correlation=101),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 60, 5, correlation=102),
        _x("cpu_op", "aten::mul", 10, 70, 10, **{"Sequence number": 8}, **fwd),
        _x("cpu_op", "aten::mse_loss", 10, 400, 50, **{"Sequence number": 9}, **fwd),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 410, 5, correlation=104),
        _x("user_annotation", "scope:optimizer", 10, 800, 100),
        _x("cuda_runtime", "cudaMemcpyAsync", 10, 810, 5, correlation=105),
        # The engine's thread.
        _x("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0", 20, 500,
           100, **{"Sequence number": 7, "Fwd thread id": 1}),
        _x("cpu_op", "aten::convolution_backward", 20, 510, 80),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 520, 5, correlation=103),
        _x("cpu_op", "MulBackward0", 20, 610, 150, **{"Sequence number": 8,
                                                      "Fwd thread id": 1}),
        _x("user_annotation", "scope:model.rendering_network", 20, 620, 50),
        _x("cpu_op", "aten::sigmoid", 20, 630, 20, **{"Sequence number": 1}, **fwd),
        _x("cpu_op", "SigmoidBackward0", 20, 700, 40, **{"Sequence number": 1,
                                                         "Fwd thread id": eng}),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 710, 5, correlation=106),
    ]
    device = [
        _x("kernel", "conv_fprop_kernel", 7, 40, 10, correlation=101),
        _x("kernel", "gates_fwd_kernel<bf16,4>", 7, 70, 20, correlation=102),
        _x("kernel", "conv_dgrad_kernel", 7, 530, 40, correlation=103),
        _x("kernel", "elementwise_kernel<mse>", 7, 420, 5, correlation=104),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 8, 820, 3, correlation=105),
        _x("kernel", "sigmoid_backward_elementwise_kernel", 7, 720, 11, correlation=106),
        _x("kernel", "conv_fprop_kernel", 7, 50, 7, correlation=999, **{"External id": 3}),
    ]
    flow = {"ph": "s", "cat": "fwdbwd", "name": "fwdbwd", "pid": 1, "tid": 10, "ts": 20,
            "id": 1}
    return host + device + [flow]


def test_analyze_attributes_backward_kernels_through_sequence_numbers(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _hand_written_trace()}))
    result = profile_step.analyze(str(path))
    assert result["time_key"] == "device_us" and result["steps"] == 2
    assert result["by_scope"] == {"dynamics (convlstm hourglass)": 10 + 20 + 40 + 7,
                                  "rendering (decoder)": 11, "unattributed": 5,
                                  "optimizer/adam": 3}
    total = 10 + 20 + 40 + 5 + 3 + 11 + 7
    assert result["total_us"] == total == sum(result["by_category"].values()) == sum(
        result["by_scope"].values()) == sum(r["device_us"] for r in result["rows"])
    assert result["by_category"] == {"convolution": 57, "port_kernels": 20, "elementwise": 16,
                                     "other": 3}
    assert result["unattributed_share"] == 5 / total
    assert [r["name"] for r in result["unattributed_top"]] == ["elementwise_kernel<mse>"]
    conv = next(r for r in result["rows"] if r["name"] == "conv_fprop_kernel")
    assert (conv["calls"], conv["calls_per_step"], conv["device_us"]) == (2, 1.0, 17)


def test_cpu_profile_runs_to_its_tables(tmp_path):
    """A tiny profile on the CPU: the three tables, the JAX tool's JSON
    keys, every scope present, the tables summing to one total; then the
    same trace reused without capturing."""
    argv = ["--device", "cpu", "--px", "32", "--batch", "2", "--t", "4", "--steps", "1",
            "--trace-dir", str(tmp_path / "trace"), "--json", str(tmp_path / "out.json")]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = profile_step.main(argv)
    text = printed.getvalue()
    for header in ("== top 25 kernels by host self time", "== by kernel group ==",
                   "== by model scope", "== unattributed:"):
        assert header in text
    with open(tmp_path / "out.json") as f:
        written = json.load(f)
    assert {"time_key", "total_us", "by_category", "by_scope", "rows"} <= set(written)
    assert written["time_key"] == "cpu_self_us" and written["steps"] == 1
    total = written["total_us"]
    for table in ("by_category", "by_scope"):
        assert sum(written[table].values()) == pytest.approx(total, rel=1e-9)
    assert {"representation (encoder)", "dynamics (convlstm hourglass)", "rendering (decoder)",
            "action network", "vgg (perceptual)", "optimizer/adam"} <= set(written["by_scope"])
    assert all(r["cpu_self_us"] >= 0 for r in result["rows"])
    assert 0 < written["unattributed_share"] < 0.5
    with contextlib.redirect_stdout(io.StringIO()), mock.patch.object(
            profile_step, "capture", side_effect=AssertionError("captured again")):
        again = profile_step.main(argv[:-2])
    assert again["by_scope"] == result["by_scope"]


def test_cpu_profile_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        profile_step.capture(2, 1, 32, 32, 4, "unused")


def test_bench_input_pipeline_prints_the_jax_keys(monkeypatch):
    flags = ["--videos", "2", "--length", "8", "--size", "16", "--batch-size", "2",
             "--observations", "3", "--workers", "2"]
    monkeypatch.setattr(sys, "argv", ["bench_input_pipeline.py", *flags])
    outputs = []
    for run in (jax_bench.main, lambda: bench_input_pipeline.main(flags)):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            run()
        outputs.append(json.loads(printed.getvalue().strip().splitlines()[-1]))
    want, got = outputs
    assert got.keys() == want.keys() == {"thread", "process", "workers"}
    for mode in ("thread", "process"):
        assert got[mode].keys() == want[mode].keys() == {"batches_per_sec", "frames_per_sec"}
        # 2 videos of 6 samples: 6 batches of 2 in 3-frame clips.
        assert got[mode]["frames_per_sec"] == pytest.approx(
            got[mode]["batches_per_sec"] * 2 * 3, rel=1e-12)
    assert got["workers"] == want["workers"] == 2
