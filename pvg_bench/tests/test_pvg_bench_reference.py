"""The reference against the port's CPU path at a tiny size, float32, on the
benchmark's seeded weights, noise and batches."""
import numpy as np
import pytest
import torch

from pvg_bench import drive, videos
from pvg_bench.reference import data as ref_data
from pvg_bench.reference import model as ref
from pvg_bench.reference import train as ref_train
from pvg_bench.tests.tiny import SEED, tiny_config, tiny_traffic

CPU = torch.device("cpu")


def test_play_steps_match_the_port():
    config, traffic = tiny_config("bair"), tiny_traffic("play_interactive")
    session = drive.build_session(config, SEED, CPU)
    model = drive.loaded_reference(config, SEED, CPU, ref.FLOAT32, vgg=False)[0].eval()
    session.start(videos.start_observation(config, SEED, 0))
    actions = drive.segment_actions(config, SEED, 0, 6, traffic["hold_mean_frames"])
    got = np.stack([session.generate_next_u8(a) for a in actions])
    want = drive.reference_frames(config, dict(traffic, segment_frames=6), SEED, CPU, 0, model)
    # Both in float32: a level apart only where a value lies on a rounding edge.
    assert np.abs(got.astype(int) - want).max() <= 1
    assert (got != want).mean() < 1e-3


@pytest.mark.parametrize("name", ["bair", "tennis"])
def test_train_step_matches_the_port(name):
    config, traffic = tiny_config(name), tiny_traffic("train_loop")
    trainer = drive.build_trainer(config, traffic, SEED, CPU)
    batch = next(iter(trainer.dataloader))
    metrics = trainer.train_step(batch)
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}

    batching = config["training"]["batching"]
    clips = [frames for frames, _ in drive.train_videos(config, traffic, SEED)]
    frames = ref_train.schedules(config, traffic["global_step"] + 1)["frames"]
    order = ref_data.epoch_order(ref_data.sample_count([len(c) for c in clips], batching, frames),
                                 batching["batch_size"], SEED)
    want_batch = ref_data.batch(clips, batching, frames, order[0])
    np.testing.assert_array_equal(batch.observations.transpose(0, 1, 4, 2, 3), want_batch)

    model, vgg = drive.loaded_reference(config, SEED, CPU, ref.FLOAT32, vgg=True)
    model.train()
    smooth = config["training"]["trainer"].endswith("smooth_mi_trainer")
    mi = torch.full((7, 7), 1 / 49) if smooth else None
    noise = ref.generator_noise(torch.Generator().manual_seed(SEED))
    total, _ = ref_train.loss(model, vgg, config, torch.from_numpy(want_batch), noise,
                              ref_train.schedules(config, traffic["global_step"] + 1), mi)
    params = list(model.named_parameters())
    want = torch.autograd.grad(total, [p for _, p in params], allow_unused=True)
    assert metrics["loss"] == pytest.approx(float(total.detach()), rel=1e-5)
    want = {n: torch.zeros_like(grads[n]) if g is None else g for (n, _), g in zip(params, want)}
    median = float(torch.stack([g.norm() for g in want.values()]).median())
    for n, g in want.items():
        # Float32 summation orders differ: each leaf as a whole, against its
        # norm or the median leaf's, as the benchmark's check measures.
        assert float((grads[n] - g).norm()) <= 1e-4 * max(float(g.norm()), median), n
