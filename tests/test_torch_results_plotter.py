"""The port's results plotter against the JAX package's on the CPU, on a
``data.yml`` that the port's offline evaluation wrote (the generic tennis
protocol with the motion-blob detector, so that the detection curves
exist): the loaded results, every per-position curve, and the figures.
"""
import os

import numpy as np
import pytest
from torch_parity import single_threaded_torch  # noqa: F401 (an autouse fixture)

from playablevideogeneration_tpu.evaluation.plotting import results_plotter as jax_plotter
from playablevideogeneration_tpu_torch.cli.evaluate_dataset import evaluate_dataset
from playablevideogeneration_tpu_torch.config.configuration import EvaluationConfiguration
from playablevideogeneration_tpu_torch.data.synthetic import make_moving_square_video
from playablevideogeneration_tpu_torch.data.video import Video
from playablevideogeneration_tpu_torch.evaluation.plotting import results_plotter

DEFAULT_METRICS = ["mse", "psnr", "ssim", "lpips", "vgg_sim", "detection/add", "detection/mdr"]


@pytest.fixture(scope="module")
def results_file(tmp_path_factory):
    """data.yml of the port's evaluation of 2 noisy copies of 2 synthetic
    videos of 8 frames at 32x32."""
    root = tmp_path_factory.mktemp("results")
    rng = np.random.default_rng(0)
    for v in range(2):
        video = make_moving_square_video(8, 32, 32, actions_count=3, seed=v)
        video.save(str(root / "reference" / f"{v:05d}"))
        frames = [np.clip(video.get_frame_at(i).astype(int) + rng.integers(-40, 41, (32, 32, 3)),
                          0, 255).astype(np.uint8) for i in range(8)]
        metadata = [{"model": "ours", "inferred_action": int(rng.integers(0, 3))}
                    for _ in range(7)] + [{"model": "ours"}]
        Video().add_content(frames, None, None, metadata, None).save(
            str(root / "generated" / f"{v:05d}"))
    config = EvaluationConfiguration(config={
        "logging": {"run_name": "plotted", "output_root": str(root / "out")},
        "data": {"target_input_size": [32, 32], "actions_count": 3,
                 "ground_truth_available": True},
        "reference_data": {"data_root": str(root / "reference"), "crop": None},
        "generated_data": {"data_root": str(root / "generated"), "crop": None},
        "evaluation": {"evaluator": "evaluation.dataset_evaluator", "detector": "blob",
                       "batching": {"batch_size": 1, "observations_count": 8, "skip_frames": 0,
                                    "observation_stacking": 1, "num_workers": 1}},
    })
    config.check_config()
    config.create_directory_structure()
    config = config.get_config()
    import playablevideogeneration_tpu_torch.evaluation.plotting.density_plots as density_plots

    plot_all, density_plots.plot_all = density_plots.plot_all, lambda *a, **k: None
    try:  # the action-space plots are not under test here
        evaluate_dataset(config, device="cpu")
    finally:
        density_plots.plot_all = plot_all
    return os.path.join(config["logging"]["output_directory"], "data.yml")


def test_results_and_curves_match_jax(results_file):
    got, want = results_plotter.load_results(results_file), jax_plotter.load_results(results_file)
    assert got == want
    found = 0
    for metric in DEFAULT_METRICS + ["motion_masked_mse", "detection/detection_rate"]:
        curve = results_plotter.positional_curve(got, metric)
        want_curve = jax_plotter.positional_curve(want, metric)
        if want_curve is None:
            assert curve is None, metric
            continue
        found += 1
        assert curve.shape == (8,) or metric.startswith("detection"), (metric, curve.shape)
        np.testing.assert_array_equal(curve, want_curve)
    assert found >= 6
    assert results_plotter.positional_curve(got, "lpips") is None  # no LPIPS weights


def test_positional_curve_orders_positions_and_escapes_the_prefix():
    results = {"a.b/10": 3.0, "a.b/2": 2.0, "a.b/0": 1.0, "axb/1": 9.0, "a.b/avg": 5.0,
               "a.b/1/var": 7.0}
    np.testing.assert_array_equal(results_plotter.positional_curve(results, "a.b"), [1, 2, 3])
    np.testing.assert_array_equal(results_plotter.positional_curve(results, "a.b"),
                                  jax_plotter.positional_curve(results, "a.b"))
    assert results_plotter.positional_curve(results, "c") is None


def test_plots_are_written_as_by_jax(results_file, tmp_path):
    pytest.importorskip("matplotlib")
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    results_plotter.main(["--results", results_file, results_file, "--labels", "a", "b",
                          "--output", str(ours)])
    jax_plotter.plot_metric_curves([results_file] * 2, ["a", "b"], DEFAULT_METRICS, str(theirs))
    files = sorted(os.listdir(ours))
    assert files == sorted(os.listdir(theirs))
    assert {"mse.pdf", "psnr.pdf", "ssim.pdf", "vgg_sim.pdf", "detection_add.pdf",
            "detection_mdr.pdf"} <= set(files) and "lpips.pdf" not in files
    assert all(os.path.getsize(ours / f) > 0 for f in files)
