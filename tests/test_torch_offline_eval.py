"""Parity of the port's offline evaluation with the JAX package, on the
CPU: the evaluation-dataset builder and ``evaluate_dataset`` with the
generic (blob detector), Breakout and BAIR evaluators; and the in-memory
path with Pillow and PyYAML blocked, as the card's machine runs it.

The builder runs the conftest tiny model with the same seeded weights in
both packages and the noise patched to one numpy source, reset before
each batch's forward on both sides (the JAX forward draws it when it is
traced, once per batch shape).  Tolerances: the reconstructions before
quantisation and the encoded actions rtol 1e-3 / atol 2e-4 (the harness's
tolerance), uint8 frames within one level, inferred actions exact;
metrics rtol 1e-4 (the variances of per-observation metrics: the bound
that values agreeing to 1e-5 give, ``_assert_metrics_close``), with the
same keys and markers, and ``data.yml`` read back by ``yaml.safe_load``
equal to the metrics.
"""
import copy
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    NOISE, patched_noise, random_variables, single_threaded_torch)

from playablevideogeneration_tpu.cli import evaluate_dataset as jax_evaluate_cli
from playablevideogeneration_tpu.config.configuration import Configuration as JaxConfiguration
from playablevideogeneration_tpu.config.configuration import (
    EvaluationConfiguration as JaxEvaluationConfiguration,
)
from playablevideogeneration_tpu.data import transforms as jax_transforms
from playablevideogeneration_tpu.data.synthetic import make_synthetic_config
from playablevideogeneration_tpu.data.video import Video as JaxVideo
from playablevideogeneration_tpu.data.video_dataset import VideoDataset as JaxVideoDataset
from playablevideogeneration_tpu.evaluation.builder import (
    EvaluationDatasetBuilder as JaxBuilder,
)
from playablevideogeneration_tpu.models import vgg as jax_vgg
from playablevideogeneration_tpu.utils import pretrained as jax_pretrained
from playablevideogeneration_tpu.utils.logging import Logger as JaxLogger
from playablevideogeneration_tpu_torch.cli import evaluate_dataset as evaluate_cli
from playablevideogeneration_tpu_torch.config.configuration import EvaluationConfiguration
from playablevideogeneration_tpu_torch.data.synthetic import make_moving_square_video
from playablevideogeneration_tpu_torch.data.transforms import make_train_transform
from playablevideogeneration_tpu_torch.data.video import Video, read_frame
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset
from playablevideogeneration_tpu_torch.evaluation.builder import EvaluationDatasetBuilder
from playablevideogeneration_tpu_torch.models.caddy import Caddy
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables
from playablevideogeneration_tpu_torch.utils.logging import Logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-3, atol=2e-4)
METRIC_TOL = dict(rtol=1e-4, atol=1e-9)
VALUE_RTOL = 1e-5
FRAME_METRICS = ("mse", "motion_masked_mse", "psnr", "ssim", "vgg_sim", "lpips")
BUILDER_BATCH = 4  # 22 test sequences: five full batches and a ragged one of 2


@pytest.fixture(scope="module", autouse=True)
def shared_noise():
    with patched_noise():
        yield


@pytest.fixture(scope="module")
def weights(tiny_variables):
    vgg_shapes = jax.eval_shape(jax_vgg.random_vgg_variables, jax.random.PRNGKey(0))
    return random_variables(tiny_variables, seed=61), random_variables(vgg_shapes, seed=62)


def _noise_reset_before(forward):
    def wrapped(*args):
        NOISE.reset()
        return forward(*args)
    return wrapped


@pytest.fixture(scope="module")
def builders(tiny_model, weights, synthetic_dataset_dir, tmp_path_factory):
    """(JAX builder, port builder) over the conftest synthetic test split,
    each writing under its own output root."""
    root = tmp_path_factory.mktemp("builder")
    made = []
    for name in ("jax", "port"):
        config = make_synthetic_config(data_root=synthetic_dataset_dir,
                                       output_root=str(root / name), height=32, width=32,
                                       actions_count=3, observation_stacking=2,
                                       hidden_state_size=8, state_features=8)
        config["evaluation"]["batching"]["batch_size"] = BUILDER_BATCH
        JaxConfiguration(config=config).check_config()
        made.append(config)
    path = os.path.join(synthetic_dataset_dir, "test")
    batching = made[0]["evaluation"]["batching"]
    jax_builder = JaxBuilder(made[0], tiny_model, JaxVideoDataset(
        path, batching, jax_transforms.make_train_transform(None, (32, 32))), JaxLogger())
    model = load_jax_variables(Caddy(tiny_model.actions_count, tiny_model.action_space_dimension,
                                     tiny_model.state_features, tiny_model.state_resolution,
                                     tiny_model.hidden_state_size,
                                     tiny_model.observation_stacking), weights[0])
    builder = EvaluationDatasetBuilder(made[1], model, VideoDataset(
        path, batching, make_train_transform(None, (32, 32))), Logger())
    jax_builder._forward = _noise_reset_before(jax_builder._forward)
    builder._forward = _noise_reset_before(builder._forward)
    return jax_builder, builder


def test_builder_reconstructions_match_jax(builders, weights):
    """Per batch, the ragged last one included: the [0, 1] frames before
    quantisation, the inferred actions (exact) and the encoded actions."""
    jax_builder, builder = builders
    batches = list(builder.dataloader)
    assert [len(b.actions) for b in batches] == [4, 4, 4, 4, 4, 2]
    builder.model.eval()
    for batch in batches:
        frames, out = builder.reconstruct(batch, torch.Generator())
        want = jax_builder._forward(weights[0], jnp.asarray(batch.observations),
                                    jnp.asarray(batch.actions), jax.random.PRNGKey(0))
        recon = jnp.concatenate([jnp.asarray(batch.observations)[:, 0:1, ..., 0:3],
                                 want.reconstructed_observations], axis=1)
        np.testing.assert_allclose(frames.permute(0, 1, 3, 4, 2).numpy(),
                                   (np.asarray(recon) + 1.0) / 2.0, **TOL)
        np.testing.assert_array_equal(out.selected_actions.numpy(),
                                      np.asarray(want.selected_actions))
        np.testing.assert_allclose(out.sampled_action_directions.numpy(),
                                   np.asarray(want.sampled_action_directions), **TOL)


def test_builder_videos_match_jax(builders, weights):
    """``build_videos`` (in memory) and ``build`` (on disk) against the JAX
    build: the same videos, uint8 frames within one level, the metadata
    keys with the inferred actions exact; the model's training mode and
    its statistics are left as they were."""
    jax_builder, builder = builders
    jax_path = jax_builder.build(weights[0])
    model = builder.model.train()
    before = {k: v.clone() for k, v in model.named_buffers()}
    videos = builder.build_videos()
    path = builder.build()
    assert model.training and all(m.training for m in model.modules())
    for key, value in model.named_buffers():
        assert torch.equal(value, before[key]), key

    names = sorted(os.listdir(jax_path))
    assert len(names) == len(videos) == 22 and sorted(os.listdir(path)) == names
    for video, name in zip(videos, names):
        want = JaxVideo()
        want.load(os.path.join(jax_path, name))
        on_disk = Video().load(os.path.join(path, name))
        assert video.get_frames_count() == want.get_frames_count() == 6
        for i in range(6):
            frame = video.get_frame_at(i)
            assert frame.dtype == np.uint8 and frame.shape == (32, 32, 3)
            np.testing.assert_array_equal(on_disk.get_frame_at(i), frame)
            assert np.abs(frame.astype(int) - np.asarray(
                want.get_frame_at(i)).astype(int)).max() <= 1
        assert len(video.metadata) == len(want.metadata) == 6
        assert video.metadata[-1] == want.metadata[-1] == {"model": "ours"}
        for got_meta, want_meta in zip(video.metadata[:-1], want.metadata[:-1]):
            assert sorted(got_meta) == ["encoded_action", "inferred_action", "model"]
            assert got_meta["inferred_action"] == want_meta["inferred_action"]
            assert isinstance(got_meta["inferred_action"], int)
            np.testing.assert_allclose(got_meta["encoded_action"], want_meta["encoded_action"],
                                       **TOL)
        assert on_disk.metadata == video.metadata
        assert video.actions == want.actions and video.dones == want.dones


# --------------------------------------------------------------------- #
# evaluate_dataset                                                      #
# --------------------------------------------------------------------- #


def _write_eval_datasets(root, videos=2, length=12, size=32, actions=3, fixed_y=None):
    """A reference and a generated dataset on disk: the generated videos
    are the reference's frames with seeded noise and carry inferred
    actions in their metadata, as the builder writes them."""
    ref_dir, gen_dir = os.path.join(root, "reference"), os.path.join(root, "generated")
    rng = np.random.default_rng(0)
    for v in range(videos):
        video = make_moving_square_video(length, size, size, actions_count=actions, seed=v,
                                         fixed_y=fixed_y)
        video.save(os.path.join(ref_dir, f"{v:05d}"))
        frames = [np.clip(video.get_frame_at(i).astype(int)
                          + rng.integers(-40, 41, (size, size, 3)), 0, 255).astype(np.uint8)
                  for i in range(length)]
        metadata = [{"model": "ours", "inferred_action": int(rng.integers(0, actions))}
                    for _ in range(length - 1)] + [{"model": "ours"}]
        Video().add_content(frames, None, None, metadata, None).save(
            os.path.join(gen_dir, f"{v:05d}"))
    return ref_dir, gen_dir


def _eval_config(root, ref_dir, gen_dir, evaluator, detector=None, length=12, size=32,
                 actions=3):
    config = {
        "logging": {"run_name": "synthetic_eval", "output_root": str(root)},
        "data": {"target_input_size": [size, size], "actions_count": actions,
                 "ground_truth_available": True},
        "reference_data": {"data_root": ref_dir, "crop": None},
        "generated_data": {"data_root": gen_dir, "crop": None},
        "evaluation": {"evaluator": evaluator,
                       "batching": {"batch_size": 1, "observations_count": length,
                                    "skip_frames": 0, "observation_stacking": 1,
                                    "num_workers": 1}},
    }
    if detector is not None:
        config["evaluation"]["detector"] = detector
    return config


def _assert_metrics_close(got, want):
    """The same keys, strings equal, numbers within ``METRIC_TOL``.  A
    variance over positions or sequences (``<metric>/var``,
    ``<metric>/<i>/var``) cancels: where the values agree to a relative
    ``VALUE_RTOL`` (they agree to about 1e-7 here), their variances agree
    to 2 * std * |mean| * VALUE_RTOL, which is the bound used for them."""
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, str):
            assert got[key] == value, key
            continue
        tol = dict(METRIC_TOL)
        prefix, _, last = key.rpartition("/")
        if last == "var" and prefix.split("/")[0] in FRAME_METRICS:
            mean = want[prefix if prefix not in FRAME_METRICS else prefix + "/avg"]
            tol["atol"] += 2 * np.sqrt(max(value, 0.0)) * abs(mean) * VALUE_RTOL
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(value, np.float64), equal_nan=True,
                                   err_msg=key, **tol)


def _read_yaml(config):
    with open(os.path.join(config["logging"]["output_directory"], "data.yml")) as f:
        return yaml.safe_load(f)


def _evaluate_both(tmp_path, evaluator, detector=None, fixed_y=None, **backbones):
    ref_dir, gen_dir = _write_eval_datasets(str(tmp_path / "data"), fixed_y=fixed_y)
    results = []
    for name, configuration, evaluate in (
            ("jax", JaxEvaluationConfiguration, jax_evaluate_cli.evaluate_dataset),
            ("port", EvaluationConfiguration,
             lambda c, **kw: evaluate_cli.evaluate_dataset(c, device="cpu", **kw))):
        checked = configuration(config=_eval_config(tmp_path / name, ref_dir, gen_dir,
                                                    evaluator, detector))
        checked.check_config()
        checked.create_directory_structure()
        config = checked.get_config()
        results.append((evaluate(config, **copy.deepcopy(backbones)), _read_yaml(config),
                        config["logging"]["output_directory"]))
    (want, want_yaml, want_dir), (got, got_yaml, got_dir) = results
    _assert_metrics_close(got, want)
    _assert_metrics_close(got_yaml, want_yaml)
    _assert_metrics_close(got_yaml, got)
    for key in got:  # the port's file holds its own values exactly
        if isinstance(got[key], float):
            assert got_yaml[key] == got[key] or np.isnan(got[key]), key
    return got, sorted(os.listdir(got_dir)), sorted(os.listdir(want_dir))


def test_evaluate_dataset_generic_blob_detector_matches_jax(tmp_path, weights, monkeypatch):
    """The tennis protocol with the motion-blob detector, the VGG19 tree
    carried across: a live detection chain, the SVMs, and the port's
    density plots under the JAX package's file names (the JAX plots are
    skipped for time)."""
    monkeypatch.delenv("PVG_PRETRAINED_WEIGHTS", raising=False)
    monkeypatch.setattr("playablevideogeneration_tpu.evaluation.plotting.density_plots.plot_all",
                        lambda *args, **kwargs: None)
    got, files, want_files = _evaluate_both(tmp_path, "evaluation.dataset_evaluator", "blob",
                                            vgg_variables=weights[1])
    assert "detection_unavailable" not in got and got["detection/add/avg"] >= 0.0
    assert got["detection/detection_rate/reference"] >= 0.3
    assert "action_space_unavailable" not in got
    assert "action_classification/linear/accuracy" in got
    for marker in ("lpips_unavailable", "fid_unavailable", "fvd_unavailable"):
        assert marker in got
    assert "vgg_sim_note" not in got
    assert want_files == ["data.yml"]
    assert files == sorted(["data.yml", "action_density_dim_0.pdf", "action_density_dim_1.pdf",
                            "2d_action_density_merged.pdf", "2d_action_directions.pdf"]
                           + [f"2d_action_density_action_{a}.pdf" for a in range(3)])


def test_evaluate_dataset_breakout_matches_jax(tmp_path, monkeypatch):
    """The Breakout protocol, the squares on the platform's band; without
    VGG weights both packages use their own random VGG19, so the VGG
    similarity is compared by its keys only."""
    monkeypatch.delenv("PVG_PRETRAINED_WEIGHTS", raising=False)
    for module in ("playablevideogeneration_tpu", "playablevideogeneration_tpu_torch"):
        monkeypatch.setattr(f"{module}.evaluation.plotting.density_plots.plot_all",
                            lambda *args, **kwargs: None)
    ref_dir, gen_dir = _write_eval_datasets(str(tmp_path / "data"), fixed_y=24)
    metrics = {}
    for name, configuration, evaluate in (
            ("jax", JaxEvaluationConfiguration, jax_evaluate_cli.evaluate_dataset),
            ("port", EvaluationConfiguration,
             lambda c: evaluate_cli.evaluate_dataset(c, device="cpu"))):
        checked = configuration(config=_eval_config(
            tmp_path / name, ref_dir, gen_dir, "evaluation.dataset_evaluator_breakout"))
        checked.check_config()
        metrics[name] = evaluate(checked.get_config())
    got, want = metrics["port"], metrics["jax"]
    assert got["vgg_sim_note"] == want["vgg_sim_note"]
    assert "detection/add/avg" in got and "action_variance/avg_variance/global" in got
    _assert_metrics_close({k: v for k, v in got.items() if not k.startswith("vgg_sim/")},
                          {k: v for k, v in want.items() if not k.startswith("vgg_sim/")})
    assert sorted(got) == sorted(want)


def test_evaluate_dataset_bair_with_lpips_matches_jax(tmp_path, weights, monkeypatch):
    """The BAIR protocol (movements from the reference's metadata states,
    no detection metric) with VGG19 and LPIPS heads found as converted
    files, and the Inception Score asked for without its weights."""
    weights_dir = tmp_path / "weights"
    jax_pretrained.save_variables_npz(weights[1], str(weights_dir / "vgg19.npz"))
    rng = np.random.default_rng(12)
    np.savez(weights_dir / "lpips_lin.npz", **{f"lin{i}": rng.uniform(0, 1, c)
                                                for i, c in enumerate((64, 128, 256, 512, 512))})
    monkeypatch.setenv("PVG_PRETRAINED_WEIGHTS", str(weights_dir))
    for module in ("playablevideogeneration_tpu", "playablevideogeneration_tpu_torch"):
        monkeypatch.setattr(f"{module}.evaluation.plotting.density_plots.plot_all",
                            lambda *args, **kwargs: None)
    ref_dir, gen_dir = _write_eval_datasets(str(tmp_path / "data"))
    metrics = {}
    for name, configuration, evaluate in (
            ("jax", JaxEvaluationConfiguration, jax_evaluate_cli.evaluate_dataset),
            ("port", EvaluationConfiguration,
             lambda c: evaluate_cli.evaluate_dataset(c, device="cpu"))):
        config = _eval_config(tmp_path / name, ref_dir, gen_dir,
                              "evaluation.dataset_evaluator_bair")
        config["evaluation"]["compute_inception_score"] = True
        checked = configuration(config=config)
        checked.check_config()
        metrics[name] = (evaluate(checked.get_config()), _read_yaml(checked.get_config()))
    (got, got_yaml), (want, want_yaml) = metrics["port"], metrics["jax"]
    _assert_metrics_close(got, want)
    _assert_metrics_close(got_yaml, want_yaml)
    assert "lpips/avg" in got and "vgg_sim_note" not in got
    assert "detection_unavailable" in got and "detection/add/avg" not in got
    assert "inception_score_unavailable" in got
    assert "action_variance/avg_variance/global" in got


def test_evaluate_dataset_without_detector_matches_jax(tmp_path, weights, monkeypatch):
    """The generic protocol with no detector: detection and action space
    unavailable in both packages."""
    monkeypatch.delenv("PVG_PRETRAINED_WEIGHTS", raising=False)
    got, _, _ = _evaluate_both(tmp_path, "evaluation.dataset_evaluator", "none",
                               vgg_variables=weights[1])
    assert "detection_unavailable" in got and "action_space_unavailable" in got


def test_bair_evaluator_reads_4d_metadata_states(tmp_path, monkeypatch):
    """As tests/test_dataset_evaluation.py's BAIR case: 4-D arm states on the
    reference videos only feed the movements, and no detection metric is
    computed."""
    monkeypatch.delenv("PVG_PRETRAINED_WEIGHTS", raising=False)
    monkeypatch.setattr(
        "playablevideogeneration_tpu_torch.evaluation.plotting.density_plots.plot_all",
        lambda *args, **kwargs: None)
    ref_dir, gen_dir = _write_eval_datasets(str(tmp_path / "data"))
    rng = np.random.default_rng(3)
    for name in os.listdir(ref_dir):
        video = Video().load(os.path.join(ref_dir, name))
        for meta in video.metadata:
            meta["state"] = rng.normal(size=4).tolist()
        Video().add_content([video.get_frame_at(i) for i in range(video.get_frames_count())],
                            video.actions, video.rewards, video.metadata, video.dones).save(
            os.path.join(ref_dir, name))
    checked = EvaluationConfiguration(config=_eval_config(
        tmp_path / "out", ref_dir, gen_dir, "evaluation.dataset_evaluator_bair"))
    checked.check_config()
    metrics = evaluate_cli.evaluate_dataset(checked.get_config(), device="cpu")
    assert "detection_unavailable" in metrics and "detection/add/avg" not in metrics
    assert "action_space_unavailable" not in metrics
    assert len(metrics["action_variance/mean_vector/global"]) == 4


def test_evaluate_dataset_refuses_mismatched_and_out_of_range_data(tmp_path):
    ref_dir, gen_dir = _write_eval_datasets(str(tmp_path / "data"))
    checked = EvaluationConfiguration(config=_eval_config(
        tmp_path / "out", ref_dir, gen_dir, "evaluation.dataset_evaluator"))
    checked.check_config()
    config = checked.get_config()
    batching = config["evaluation"]["batching"]
    video = make_moving_square_video(12, 32, 32, seed=3)
    signed = VideoDataset.from_videos([video], batching, make_train_transform(None, (32, 32)))
    with pytest.raises(ValueError, match="differ in size"):
        evaluate_cli.evaluate_dataset(config, device="cpu", datasets=(signed, VideoDataset(
            gen_dir, batching, make_train_transform(None, (32, 32)))))
    with pytest.raises(ValueError, match=r"outside allowed range \[0, 1\]"):
        evaluate_cli.evaluate_dataset(config, device="cpu", datasets=(signed, signed))


def test_chip_smoke_bair_evaluation_config_is_the_yaml():
    """``chip_smoke.py`` builds BAIR's evaluation config as a dict (the
    card's machine has no PyYAML): it must be
    ``configs/evaluation/01_bair.yaml``."""
    import chip_smoke

    with open(os.path.join(REPO, "configs", "evaluation", "01_bair.yaml")) as f:
        assert chip_smoke.BAIR_EVALUATION_CONFIG == yaml.safe_load(f)


def test_in_memory_path_needs_neither_pillow_nor_yaml(tmp_path):
    """With PIL, yaml, jax, flax and the JAX package blocked: the builder's
    in-memory videos and ``evaluate_dataset(datasets=...)`` with LPIPS run
    and write ``data.yml``; ``build`` and ``save_session`` refuse with an
    ImportError that names Pillow."""
    script = textwrap.dedent(f"""
        import sys
        BLOCKED = {{"PIL", "yaml", "jax", "jaxlib", "flax", "playablevideogeneration_tpu"}}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import os
        import numpy as np
        import torch
        torch.set_num_threads(1)  # the suite runs in several processes at once
        from playablevideogeneration_tpu_torch.cli.evaluate_dataset import evaluate_dataset
        from playablevideogeneration_tpu_torch.cli.play import save_session
        from playablevideogeneration_tpu_torch.config.configuration import (
            Configuration, EvaluationConfiguration)
        from playablevideogeneration_tpu_torch.data.synthetic import (
            make_moving_square_video, make_synthetic_config)
        from playablevideogeneration_tpu_torch.data.transforms import (
            make_evaluation_transform, make_train_transform)
        from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset
        from playablevideogeneration_tpu_torch.evaluation.builder import EvaluationDatasetBuilder
        from playablevideogeneration_tpu_torch.evaluation.metrics.lpips import make_lpips_fn
        from playablevideogeneration_tpu_torch.models.caddy import make_model
        from playablevideogeneration_tpu_torch.models.vgg import make_vgg
        from playablevideogeneration_tpu_torch.utils.logging import Logger

        root = {str(tmp_path)!r}
        config = make_synthetic_config(data_root=root, output_root=root, height=32, width=32,
                                       actions_count=3, observation_stacking=1,
                                       hidden_state_size=8, state_features=8)
        Configuration(config=config).check_config(check_data_root=False)
        batching = config["evaluation"]["batching"]
        videos = [make_moving_square_video(8, 32, 32, seed=s) for s in range(2)]
        dataset = VideoDataset.from_videos(videos, batching, make_train_transform(None, (32, 32)))
        builder = EvaluationDatasetBuilder(config, make_model(config, "cpu"), dataset, Logger())
        generated = builder.build_videos()
        assert len(generated) == 6 and generated[0].get_frame_at(0).dtype == np.uint8
        frame = np.zeros((4, 4, 3))
        for fn in (builder.build, lambda: save_session([frame], [0], root, Logger())):
            try:
                fn()
                raise AssertionError("no ImportError")
            except ImportError as e:
                assert "Pillow" in str(e), e

        evaluation = {{"logging": {{"run_name": "eval", "output_root": root}},
                      "data": {{"target_input_size": [32, 32], "actions_count": 3}},
                      "reference_data": {{"data_root": root}},
                      "generated_data": {{"data_root": root}},
                      "evaluation": {{"evaluator": "evaluation.dataset_evaluator_bair",
                                     "batching": batching}}}}
        EvaluationConfiguration(config=evaluation).check_config()
        transform = make_evaluation_transform(None, (32, 32))
        datasets = (VideoDataset.from_videos(videos, batching, transform),
                    VideoDataset.from_videos(generated, batching, transform))
        lpips = make_lpips_fn(make_vgg("cpu"), [np.ones(c) for c in (64, 128, 256, 512, 512)])
        metrics = evaluate_dataset(evaluation, device="cpu", datasets=datasets, lpips_fn=lpips)
        assert "lpips/avg" in metrics and "fid_unavailable" in metrics
        assert os.path.isfile(os.path.join(root, "eval", "data.yml"))
        print(len(metrics))
    """)
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                            text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    with open(tmp_path / "eval" / "data.yml") as f:
        assert len(yaml.safe_load(f)) == int(result.stdout.split()[-1])
