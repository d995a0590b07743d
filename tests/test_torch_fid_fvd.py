"""Parity of the port's FID, FVD and Inception Score pipeline with the JAX
package, on the CPU: the streamed statistics and distances (exact: the
same float64 numpy on the same activations), the FID CLI (the cases of
tests/test_metrics.py, with Pillow), the backbones found from the config,
and both packages' ``evaluate_dataset`` on the same converted
``fid_inception.npz`` and ``i3d.npz`` at the full input sizes (299, 224).

In the evaluation, the activations that each backbone returns agree
within the tap tolerance of ``tests/test_backbone_parity.py`` (atol 2e-3
* max(scale, 0.1), rtol 5e-3) and the class probabilities within 1e-5.
The distances agree within ``DISTANCE_RTOL``, 1e-4: with 18 frames and
3 videos per dataset the covariances have rank 17 and 2 in 2048 and 400
dimensions, and the square root of their singular product could amplify
the activations' differences, but the distances (FID 18.5, FVD 9.9 here)
differed by 6e-8 and 1.8e-6 relative when this was written.  The
Inception Score (1.00002: the random head is nearly uniform) agrees
within 1e-9 and its deviation over the splits within 1e-4 relative (both
measured 1e-11 and 1.2e-6).
"""
import os

import numpy as np
import pytest
import yaml
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    assert_tap_close, single_threaded_torch)

from playablevideogeneration_tpu.cli import evaluate_dataset as jax_evaluate_cli
from playablevideogeneration_tpu.cli import fid as jax_fid_cli
from playablevideogeneration_tpu.config.configuration import (
    EvaluationConfiguration as JaxEvaluationConfiguration,
)
from playablevideogeneration_tpu.evaluation.metrics import fid as jax_fid
from playablevideogeneration_tpu.evaluation.metrics import fvd as jax_fvd
from playablevideogeneration_tpu.evaluation.metrics import i3d as jax_i3d
from playablevideogeneration_tpu.evaluation.metrics import inception as jax_inception
from playablevideogeneration_tpu.utils import pretrained as jax_pretrained
from playablevideogeneration_tpu_torch.cli import evaluate_dataset as evaluate_cli
from playablevideogeneration_tpu_torch.cli import fid as fid_cli
from playablevideogeneration_tpu_torch.config.configuration import EvaluationConfiguration
from playablevideogeneration_tpu_torch.data.synthetic import make_moving_square_video
from playablevideogeneration_tpu_torch.data.video import Video
from playablevideogeneration_tpu_torch.evaluation.metrics import fid, fvd, i3d, inception
from playablevideogeneration_tpu_torch.utils import pretrained

DISTANCE_RTOL = 1e-4
VIDEOS, FRAMES, SIZE = 3, 6, 32


def fake_extractor(frames):
    """A cheap deterministic (N, 4) feature map of (N, H, W, 3) frames."""
    flat = np.asarray(frames).reshape(len(frames), -1)
    return np.stack([flat.mean(1), flat.std(1), flat.max(1), flat.min(1)], axis=1)


def frame_batches(seed, sizes, size=8):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32) for n in sizes]


# --------------------------------------------------------------------- #
# Statistics and distances: exact                                       #
# --------------------------------------------------------------------- #


def test_fid_statistics_and_distance_match_jax():
    a, b = frame_batches(0, [3, 4, 2]), frame_batches(1, [5, 1])
    got = fid.compute_statistics_from_frames(fake_extractor, a)
    want = jax_fid.compute_statistics_from_frames(fake_extractor, a)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    acts = fake_extractor(np.concatenate(a)).astype(np.float64)
    np.testing.assert_allclose(got[1], np.cov(acts, rowvar=False), rtol=1e-9, atol=1e-15)
    distance = fid.compute_fid(fake_extractor, a, b)
    assert distance == jax_fid.compute_fid(fake_extractor, a, b) and distance > 0
    assert abs(fid.compute_fid(fake_extractor, a, a)) < 1e-9
    with pytest.raises(ValueError, match="at least 2 frames"):
        fid.compute_statistics_from_frames(fake_extractor, frame_batches(2, [1]))


def test_fvd_flushes_batches_of_16_and_matches_jax():
    """Batches of 5 videos: the buffer flushes at 20 and then holds the
    last 15, in both packages; the distances are equal."""
    rng = np.random.default_rng(3)
    reference = [rng.uniform(0, 1, (5, 4, 8, 8, 3)) for _ in range(7)]
    generated = [np.clip(v + rng.normal(0, 0.1, v.shape), 0, 1) for v in reference]
    calls = {"port": [], "jax": []}

    def recorded(name):
        def embed(videos):
            calls[name].append(len(videos))
            return fvd.naive_video_embedder(videos)
        return embed

    got = fvd.compute_fvd(recorded("port"), iter(reference), iter(generated))
    want = jax_fvd.compute_fvd(recorded("jax"), iter(reference), iter(generated))
    assert calls["port"] == calls["jax"] == [20, 15, 20, 15]
    assert fvd.EMBED_BATCH == jax_fvd.EMBED_BATCH == 16
    assert got == want and got > 0
    with pytest.raises(ValueError, match="at least 2 videos"):
        fvd.compute_fvd(fvd.naive_video_embedder, iter([reference[0][:1]]), iter(generated))


def test_naive_video_embedder_matches_jax():
    videos = np.random.default_rng(4).uniform(0, 1, (3, 5, 10, 9, 3))
    got = fvd.naive_video_embedder(videos)
    np.testing.assert_array_equal(got, jax_fvd.naive_video_embedder(videos))
    assert got.shape == (3, 64)
    np.testing.assert_array_equal(fvd.naive_video_embedder(videos, dims=20),
                                  jax_fvd.naive_video_embedder(videos, dims=20))


# --------------------------------------------------------------------- #
# The FID CLI: tests/test_metrics.py's cases                            #
# --------------------------------------------------------------------- #


def write_images(directory, n, base, rng, size=12):
    from PIL import Image

    directory.mkdir()
    for i in range(n):
        img = np.clip(base + rng.integers(0, 40, (size, size, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(directory / f"{i:03d}.png")


def fid_printed(capsys) -> float:
    out = capsys.readouterr().out
    assert out.startswith("FID: ")
    return float(out.split("FID: ")[1])


def test_fid_cli_paths_and_stats(tmp_path, monkeypatch, capsys):
    """Image directories and ``.npz`` statistics, ``--save-stats``, batches
    of mixed resolutions; the backbone stubbed with a cheap feature map."""
    from PIL import Image

    rng = np.random.default_rng(0)
    dir_a, dir_b = tmp_path / "a", tmp_path / "b"
    write_images(dir_a, 5, 30, rng)
    write_images(dir_b, 5, 160, rng)
    monkeypatch.setattr("playablevideogeneration_tpu_torch.utils.pretrained.get_fid_extractor",
                        lambda config, **kwargs: fake_extractor)

    fid_cli.main([str(dir_a), str(dir_b), "--batch-size", "2", "--quiet"])
    cross = fid_printed(capsys)
    assert np.isfinite(cross) and cross > 0
    fid_cli.main([str(dir_a), str(dir_a), "--quiet"])
    assert fid_printed(capsys) == pytest.approx(0.0, abs=1e-6)

    stats = tmp_path / "stats" / "a.npz"
    fid_cli.main(["--save-stats", str(dir_a), str(stats), "--quiet"])
    capsys.readouterr()
    assert stats.is_file()
    fid_cli.main([str(stats), str(dir_b), "--quiet"])
    assert fid_printed(capsys) == pytest.approx(cross, rel=1e-9)

    Image.fromarray(np.full((20, 20, 3), 30, np.uint8)).save(dir_a / "zzz_big.png")
    fid_cli.main([str(dir_a), str(dir_b), "--quiet"])
    assert np.isfinite(fid_printed(capsys))


def test_fid_cli_requires_weights_for_image_paths(tmp_path, monkeypatch, capsys):
    from PIL import Image

    d = tmp_path / "imgs"
    d.mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(d / "0.png")
    monkeypatch.delenv("PVG_PRETRAINED_WEIGHTS", raising=False)
    monkeypatch.setattr("playablevideogeneration_tpu_torch.utils.pretrained.get_fid_extractor",
                        lambda config, **kwargs: None)
    with pytest.raises(SystemExit, match="No FID InceptionV3 weights"):
        fid_cli.main([str(d), str(d)])
    np.savez(tmp_path / "s1.npz", mu=np.zeros(4), sigma=np.eye(4))
    np.savez(tmp_path / "s2.npz", mu=np.ones(4), sigma=np.eye(4))
    fid_cli.main([str(tmp_path / "s1.npz"), str(tmp_path / "s2.npz")])
    jax_fid_cli.main([str(tmp_path / "s1.npz"), str(tmp_path / "s2.npz")])
    got, want = capsys.readouterr().out.splitlines()
    assert got == want == "FID:  4.0"


# --------------------------------------------------------------------- #
# Backbones from converted weights                                      #
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    """The port's seeded variables in the JAX layout, written by the JAX
    package's writer: ``fid_inception.npz`` with a 1008-way ``fc`` head and
    ``i3d.npz``."""
    directory = tmp_path_factory.mktemp("weights")
    jax_pretrained.save_variables_npz(inception.random_inception_variables(41),
                                      str(directory / "fid_inception.npz"))
    jax_pretrained.save_variables_npz(i3d.random_i3d_variables(43), str(directory / "i3d.npz"))
    return directory


def test_getters_return_none_without_weights(monkeypatch):
    monkeypatch.delenv("PVG_PRETRAINED_WEIGHTS", raising=False)
    config = {"tpu": {}, "evaluation": {"compute_inception_score": True}}
    assert pretrained.get_fid_extractor(config, device="cpu") is None
    assert pretrained.get_class_probability_fn(config, device="cpu") is None
    assert pretrained.get_fvd_embedder(config, device="cpu") is None
    backbones = pretrained.evaluation_backbones(config, device="cpu")
    assert sorted(backbones) == ["class_probability_fn", "fid_extractor", "fvd_embedder",
                                 "lpips_fn", "vgg_variables"]
    assert all(value is None for value in backbones.values())


def test_class_probabilities_need_the_fc_head(weights_dir):
    variables = pretrained.load_variables_npz(str(weights_dir / "fid_inception.npz"))
    del variables["params"]["fc"]
    config = {"tpu": {}}
    assert pretrained.get_class_probability_fn(config, variables=variables, device="cpu") is None
    assert jax_pretrained.get_class_probability_fn(config, variables=variables) is None
    extract = pretrained.get_fid_extractor(config, variables=variables, device="cpu")
    assert extract is not None and extract.model.Mixed_7c.use_max_pool


def test_fid_cli_saves_the_statistics_of_jax(weights_dir, tmp_path):
    """``--save-stats`` with ``--weights`` on a directory of images of two
    sizes: the port on the CPU and the JAX package write the same mean and
    covariance, within the tap tolerance (the activations') and its
    products."""
    rng = np.random.default_rng(6)
    write_images(tmp_path / "images", 3, 60, rng, size=40)
    from PIL import Image

    Image.fromarray(rng.integers(0, 255, (24, 24, 3)).astype(np.uint8)).save(
        tmp_path / "images" / "small.png")
    weights = str(weights_dir / "fid_inception.npz")
    outputs = {}
    for name, main, extra in (("port", fid_cli.main, ["--device", "cpu"]),
                              ("jax", jax_fid_cli.main, [])):
        outputs[name] = str(tmp_path / f"{name}.npz")
        main(["--save-stats", "--weights", weights, "--quiet", str(tmp_path / "images"),
              outputs[name]] + extra)
    with np.load(outputs["port"]) as got, np.load(outputs["jax"]) as want:
        assert got["mu"].shape == (2048,) and got["sigma"].shape == (2048, 2048)
        assert_tap_close(got["mu"], want["mu"], "mu")
        scale = float(np.abs(want["mu"]).max())
        np.testing.assert_allclose(got["sigma"], want["sigma"], rtol=1e-2,
                                   atol=4e-3 * max(scale, 0.1) ** 2)


# --------------------------------------------------------------------- #
# evaluate_dataset at the full input sizes                              #
# --------------------------------------------------------------------- #


def write_datasets(root):
    """3 reference videos of ``FRAMES`` moving-square frames and 3
    generated ones (their frames with seeded noise, metadata as the
    builder writes it), on disk for the JAX package."""
    rng = np.random.default_rng(7)
    directories = (os.path.join(root, "reference"), os.path.join(root, "generated"))
    for v in range(VIDEOS):
        video = make_moving_square_video(FRAMES, SIZE, SIZE, seed=v)
        video.save(os.path.join(directories[0], f"{v:05d}"))
        frames = [np.clip(video.get_frame_at(i).astype(int)
                          + rng.integers(-40, 41, (SIZE, SIZE, 3)), 0, 255).astype(np.uint8)
                  for i in range(FRAMES)]
        metadata = [{"model": "ours", "inferred_action": int(rng.integers(0, 3))}
                    for _ in range(FRAMES - 1)] + [{"model": "ours"}]
        Video().add_content(frames, None, None, metadata, None).save(
            os.path.join(directories[1], f"{v:05d}"))
    return directories


def recording(monkeypatch, module, maker, outputs):
    """Wraps ``module.maker`` so that the functions it makes append their
    outputs to ``outputs``."""
    make = getattr(module, maker)

    def wrapped(*args, **kwargs):
        fn = make(*args, **kwargs)
        return lambda x: outputs.append(np.asarray(fn(x))) or outputs[-1]

    monkeypatch.setattr(module, maker, wrapped)


def test_evaluate_dataset_with_fid_fvd_and_inception_score_matches_jax(
        weights_dir, tmp_path, monkeypatch):
    monkeypatch.delenv("PVG_PRETRAINED_WEIGHTS", raising=False)
    for package in ("playablevideogeneration_tpu", "playablevideogeneration_tpu_torch"):
        monkeypatch.setattr(f"{package}.evaluation.plotting.density_plots.plot_all",
                            lambda *args, **kwargs: None)
    ref_dir, gen_dir = write_datasets(str(tmp_path / "data"))
    outputs, metrics = {}, {}
    for name, configuration, evaluate, modules in (
            ("jax", JaxEvaluationConfiguration, jax_evaluate_cli.evaluate_dataset,
             (jax_inception, jax_i3d)),
            ("port", EvaluationConfiguration,
             lambda c: evaluate_cli.evaluate_dataset(c, device="cpu"), (inception, i3d))):
        outputs[name] = {"fid": [], "is": [], "fvd": []}
        recording(monkeypatch, modules[0], "make_fid_extractor", outputs[name]["fid"])
        recording(monkeypatch, modules[0], "make_class_probability_fn", outputs[name]["is"])
        recording(monkeypatch, modules[1], "make_fvd_embedder", outputs[name]["fvd"])
        config = {
            "logging": {"run_name": "distribution", "output_root": str(tmp_path / name)},
            "data": {"target_input_size": [SIZE, SIZE], "actions_count": 3},
            "reference_data": {"data_root": ref_dir, "crop": None},
            "generated_data": {"data_root": gen_dir, "crop": None},
            "evaluation": {"evaluator": "evaluation.dataset_evaluator_bair",
                           "compute_inception_score": True,
                           "batching": {"batch_size": 1, "observations_count": FRAMES,
                                        "skip_frames": 0, "observation_stacking": 1,
                                        "num_workers": 1}},
            "tpu": {"pretrained_weights_dir": str(weights_dir)},
        }
        checked = configuration(config=config)
        checked.check_config()
        metrics[name] = evaluate(checked.get_config())
        with open(os.path.join(checked.get_config()["logging"]["output_directory"],
                               "data.yml")) as f:
            assert yaml.safe_load(f)["fid"] == metrics[name]["fid"]

    got, want = metrics["port"], metrics["jax"]
    assert sorted(got) == sorted(want)
    for marker in ("fid_unavailable", "fvd_unavailable", "inception_score_unavailable"):
        assert marker not in got
    # Per call: FID 2 x 3 batches of 6 frames, IS 3, FVD one batch of 3 videos per dataset.
    assert [len(outputs["port"][k]) for k in ("fid", "is", "fvd")] == [6, 3, 2]
    for key in ("fid", "fvd"):
        for i, (g, w) in enumerate(zip(outputs["port"][key], outputs["jax"][key])):
            assert_tap_close(g, w, f"{key} call {i}")
    for g, w in zip(outputs["port"]["is"], outputs["jax"]["is"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    for key in ("fid", "fvd"):
        assert np.isfinite(got[key]) and got[key] > 0
        np.testing.assert_allclose(got[key], want[key], rtol=DISTANCE_RTOL, err_msg=key)
    assert got["inception_score"] > 1.0
    np.testing.assert_allclose(got["inception_score"], want["inception_score"], rtol=1e-9)
    np.testing.assert_allclose(got["inception_score_std"], want["inception_score_std"],
                               rtol=1e-4)
