"""Data-parallel training of the port (``parallel/mesh.py``) on the CPU.

Ranks are subprocesses (tests/torch_parallel_worker.py) that join a gloo
group through ``init_method=file://`` in the test's temporary directory,
so that parallel test workers never share a port.  The model is tiny:
16x16 frames, hidden 8, 3 actions, a global batch of 4 sequences of 3
frames.

Tolerances: two ranks against one rank on the same global batch take
``__graft_entry__.dryrun_multichip``'s (the loss within 1e-3 relative; the
parameters rtol 2e-3 and atol 4 lr, since Adam's first update is about
lr * sign(g) and a gradient that reassociation moves across 0 moves its
parameter by up to 2 lr a step; the BatchNorm statistics, centroids and
MI matrix rtol 2e-3 and atol lr), the gradient norms rtol 2e-3; against
the JAX package's one-device train step, tests/test_torch_train.py's.  A
run of one rank in a group equals the one-process trainer bit for bit.
"""
import os
import pickle
import subprocess
import sys
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_worker as worker
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    NOISE, patched_noise, random_variables, single_threaded_torch)

from playablevideogeneration_tpu.config.configuration import Configuration
from playablevideogeneration_tpu.data.loader import DataLoader as JaxDataLoader
from playablevideogeneration_tpu.data.synthetic import make_synthetic_config
from playablevideogeneration_tpu.data.transforms import make_train_transform
from playablevideogeneration_tpu.data.video_dataset import VideoDataset as JaxVideoDataset
from playablevideogeneration_tpu.models.caddy import init_model_variables
from playablevideogeneration_tpu.models.caddy import make_model as jax_make_model
from playablevideogeneration_tpu.training import losses as jax_losses
from playablevideogeneration_tpu.training import trainer as jax_trainer
from playablevideogeneration_tpu.training.bench_harness import NullDataset
from playablevideogeneration_tpu.training.train_state import TrainState as JaxTrainState
from playablevideogeneration_tpu.utils.logging import Logger
from playablevideogeneration_tpu_torch.data.loader import DataLoader
from playablevideogeneration_tpu_torch.data.transforms import get_final_transforms
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset
from playablevideogeneration_tpu_torch.models.caddy import make_model
from playablevideogeneration_tpu_torch.models.vgg import make_vgg
from playablevideogeneration_tpu_torch.parallel import mesh
from playablevideogeneration_tpu_torch.training.trainer import Trainer
from playablevideogeneration_tpu_torch.utils.jax_weights import _convert, _leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
TOL = dict(rtol=1e-3, atol=2e-4)  # tests/test_torch_train.py's
LR = worker.tiny_config(0)["training"]["learning_rate"]
# The floor of the gradients' agreement with the JAX step's in the bound
# on Adam's first update: tests/test_torch_train.py takes Adam's eps,
# 1e-8, above the rounding noise of a gradient that vanishes (2e-9 there).
# Here dynamics_network.bn0.bias's gradient vanishes (the next train-mode
# BatchNorm takes its shift back out, but at the zero-padded border) and
# is rounding noise of up to 9e-9 in one process and on two ranks alike,
# its two-rank value 1.8e-8 from the JAX step's: the floor is 5e-8.
GRADIENT_NOISE = 5e-8
STATISTICS = ("running_mean", "running_var", "centroids")


def run_ranks(directory, spec: dict, world: int, local_world: Optional[int] = None) -> list:
    """Runs ``spec`` on ``world`` ranks, each a subprocess with torchrun's
    environment, on nodes of ``local_world`` ranks (default: one node);
    returns each rank's result."""
    local_world = local_world or world
    spec = dict(spec, init_method=f"file://{directory}/init",
                output=os.path.join(str(directory), "rank%d.pt"))
    spec_path = os.path.join(str(directory), "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    procs = []
    try:
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank % local_world), LOCAL_WORLD_SIZE=str(local_world),
                       OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen([sys.executable, WORKER, spec_path], cwd=REPO,
                                          env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        outputs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
    return [torch.load(spec["output"] % r, weights_only=False) for r in range(world)]


def assert_same_state(got: dict, want: dict) -> None:
    """Every tensor of two snapshots bit for bit."""
    for part in ("model", "grads"):
        assert got[part].keys() == want[part].keys()
        for key, value in want[part].items():
            assert torch.equal(got[part][key], value), (part, key)
    for name, slots in want["adam"].items():
        for key, value in slots.items():
            assert torch.equal(got["adam"][name][key], value), ("adam", name, key)
    assert torch.equal(got["mi_matrix"], want["mi_matrix"])
    assert got["step"] == want["step"]


# --------------------------------------------------------------------- #
# Two ranks, one rank and one process on the same global batch          #
# --------------------------------------------------------------------- #

# A pretraining step, then a full-phase step, with per-step activation
# checkpointing: the recompute reduces BatchNorm's sums again.
TRAIN_SPEC = dict(mode="train", steps=2, pretraining_steps=1, remat=True)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The trainer with no process group on the whole global batch; it
    saves a checkpoint for the resume on two ranks."""
    root = str(tmp_path_factory.mktemp("one_process"))
    return worker.train(dict(TRAIN_SPEC, save_root=root, save="latest")), root


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("two_ranks")
    return run_ranks(root, dict(TRAIN_SPEC, save_root=str(root), save="latest"), 2), str(root)


# A full-phase step first: each phase's first step is compared from the
# same initial state.  After a step the two sides' parameters differ by up
# to 2 lr (Adam's sign), which moves the next step's pretraining-sensitive
# gradient norms by up to 1e-2 relative on this model.
FULL_SPEC = dict(mode="train", steps=1, pretraining_steps=0, remat=True)


@pytest.fixture(scope="module")
def first_steps(two_ranks, one_process, tmp_path_factory):
    """Per phase, the first step of (two ranks, one process)."""
    full_ranks = run_ranks(tmp_path_factory.mktemp("two_ranks_full"), FULL_SPEC, 2)
    return {"pretraining": (two_ranks[0][0]["steps"][0], one_process[0]["steps"][0]),
            "full": (full_ranks[0]["steps"][0], worker.train(FULL_SPEC)["steps"][0])}


def test_one_rank_in_a_group_equals_one_process_bit_for_bit(one_process, tmp_path):
    """At one rank every collective is an identity: the distributed code
    path computes what the one-process trainer computes, bit for bit."""
    (rank,) = run_ranks(tmp_path, TRAIN_SPEC, 1)
    want = one_process[0]
    assert rank["process"] == mesh.ProcessInfo(0, 1, 0, 1)
    for got_step, want_step in zip(rank["steps"], want["steps"], strict=True):
        assert got_step["metrics"] == want_step["metrics"]
        assert_same_state(got_step["state"], want_step["state"])


def test_two_ranks_hold_the_same_state(two_ranks):
    ranks, _ = two_ranks
    assert [r["process"] for r in ranks] == [mesh.ProcessInfo(0, 2, 0, 2),
                                             mesh.ProcessInfo(1, 2, 1, 2)]
    for step0, step1 in zip(ranks[0]["steps"], ranks[1]["steps"], strict=True):
        assert step0["metrics"] == step1["metrics"]
        assert_same_state(step1["state"], step0["state"])


def assert_dryrun_close(got: dict, want: dict) -> None:
    """The loss within 1e-3 relative, the parameters rtol 2e-3 and atol
    4 lr, BatchNorm statistics, centroids and MI matrix rtol 2e-3 and atol
    lr."""
    loss, want_loss = got["metrics"]["loss"], want["metrics"]["loss"]
    assert abs(loss - want_loss) < 1e-3 * max(1.0, abs(want_loss)), (loss, want_loss)
    for key, value in want["state"]["model"].items():
        atol = LR if key.endswith(STATISTICS) else 4 * LR
        np.testing.assert_allclose(got["state"]["model"][key].numpy(), value.numpy(),
                                   rtol=2e-3, atol=atol, err_msg=key)
    np.testing.assert_allclose(got["state"]["mi_matrix"].numpy(),
                               want["state"]["mi_matrix"].numpy(), rtol=2e-3, atol=LR)


@pytest.mark.parametrize("phase", ["pretraining", "full"])
def test_two_ranks_match_one_process(first_steps, phase):
    """Each phase's first step on two ranks against one process on the same
    global batch from the same state: loss, parameters, BatchNorm
    statistics, centroids and MI matrix at the dryrun's tolerances, and
    every diagnostic and gradient norm within rtol 2e-3."""
    got, want = first_steps[phase]
    assert got["metrics"]["pretraining"] == want["metrics"]["pretraining"] == float(
        phase == "pretraining")
    assert_dryrun_close(got, want)
    assert got["metrics"].keys() == want["metrics"].keys()
    for key, value in want["metrics"].items():
        atol = 0.0 if key.startswith("grad_norm/") else 1e-5
        np.testing.assert_allclose(got["metrics"][key], value, rtol=2e-3, atol=atol,
                                   err_msg=key)


def test_two_ranks_match_one_process_after_two_steps(two_ranks, one_process):
    """After a pretraining and a full-phase step, the dryrun's tolerances
    (``dryrun_multichip`` also compares after two steps)."""
    assert_dryrun_close(two_ranks[0][0]["steps"][1], one_process[0]["steps"][1])


def test_only_rank_0_writes_the_checkpoint(two_ranks):
    ranks, root = two_ranks
    assert ranks[0]["checkpoint_writes"] == [os.path.join(root, "latest")]
    assert ranks[1]["checkpoint_writes"] == []
    assert os.listdir(os.path.join(root, "latest")) == ["state.pt"]


def test_elastic_resume(one_process, two_ranks, tmp_path):
    """One process's checkpoint resumes on two ranks and two ranks' on one
    process: the state bit for bit, and the next step's loss finite."""
    _, one_root = one_process
    ranks = run_ranks(tmp_path, dict(TRAIN_SPEC, steps=1, save_root=one_root,
                                     resume="latest"), 2)
    want = one_process[0]["steps"][-1]["state"]
    for rank in ranks:
        for key, value in want["model"].items():
            assert torch.equal(rank["resumed"]["model"][key], value), key
        for name, slots in want["adam"].items():
            for key, value in slots.items():
                assert torch.equal(rank["resumed"]["adam"][name][key], value), (name, key)
        assert torch.equal(rank["resumed"]["mi_matrix"], want["mi_matrix"])
        assert rank["resumed"]["step"] == 2
        assert np.isfinite(rank["steps"][0]["metrics"]["loss"])
        assert rank["steps"][0]["metrics"]["pretraining"] == 0.0
    assert ranks[0]["steps"][0]["metrics"] == ranks[1]["steps"][0]["metrics"]

    two_ranks_state = two_ranks[0][0]["steps"][-1]["state"]
    resumed = worker.train(dict(TRAIN_SPEC, steps=1, save_root=two_ranks[1], resume="latest"))
    for key, value in two_ranks_state["model"].items():
        assert torch.equal(resumed["resumed"]["model"][key], value), key
    assert torch.equal(resumed["resumed"]["mi_matrix"], two_ranks_state["mi_matrix"])
    assert np.isfinite(resumed["steps"][0]["metrics"]["loss"])


# --------------------------------------------------------------------- #
# Batch-nonlinear pieces, two ranks against one on the whole batch       #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def units(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("units"), dict(mode="units"), 2), \
        worker.units({})


def _cat(ranks, key):
    return torch.cat([r[key] for r in ranks]).numpy()


@pytest.mark.parametrize("piece", ["batch_norm", "mutual_information", "centroids"])
def test_two_ranks_match_one_on_the_whole_batch(units, piece):
    """Train-mode BatchNorm (output, input and parameter gradients, running
    statistics), the MI and smooth-MI losses (values, input gradients, the
    new matrix) and the centroid update on two ranks' rows against one
    process's on the concatenated batch.  Each rank's input gradient sums
    every rank's cotangent: BatchNorm's loss is a sum over the rows, so the
    ranks' gradients are the whole batch's; each rank adds the same MI, so
    theirs are ``world`` times it, as the trainer's average then divides."""
    ranks, want = units
    tol = dict(rtol=1e-5, atol=1e-6)
    if piece == "batch_norm":
        np.testing.assert_allclose(_cat(ranks, "y"), want["y"].numpy(), **tol)
        np.testing.assert_allclose(_cat(ranks, "x_grad"), want["x_grad"].numpy(), **tol)
        for key in ("weight_grad", "bias_grad"):
            np.testing.assert_allclose(sum(r[key] for r in ranks).numpy(), want[key].numpy(),
                                       err_msg=key, **tol)
        keys = ("running_mean", "running_var")
    elif piece == "mutual_information":
        for key in ("p1_grad", "p2_grad"):
            np.testing.assert_allclose(_cat(ranks, key) / 2, want[key].numpy(), err_msg=key,
                                       **tol)
        keys = ("mi", "smooth", "new_matrix")
    else:
        keys = ("centroids",)
    for key in keys:
        assert torch.equal(ranks[0][key], ranks[1][key]), key
        np.testing.assert_allclose(ranks[0][key].numpy(), want[key].numpy(), err_msg=key, **tol)


# --------------------------------------------------------------------- #
# Two ranks against the JAX package's one-device trainer                 #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_weights():
    """Seeded numpy variables of the tiny model (shapes from the JAX init,
    traced but not run) and the JAX layout of the port's seeded VGG19."""
    batch = (jnp.zeros((worker.BATCH, worker.FRAMES, worker.SIZE, worker.SIZE, 3)),
             jnp.zeros((worker.BATCH, worker.FRAMES), jnp.int32))
    model = jax_make_model(_jax_config())
    template = jax.eval_shape(
        lambda: init_model_variables(model, jax.random.PRNGKey(0), *batch))
    vgg = make_vgg("cpu", seed=worker.VGG_SEED)
    vgg_variables = {"params": {
        name: {"kernel": conv.weight.detach().permute(2, 3, 1, 0).numpy(),
               "bias": conv.bias.detach().numpy()}
        for name, conv in vgg.named_children()}}
    return model, random_variables(template, seed=11), vgg_variables


def _jax_config():
    config = make_synthetic_config(
        data_root="/nonexistent", output_root="/nonexistent", height=worker.SIZE,
        width=worker.SIZE, actions_count=worker.ACTIONS, batch_size=worker.BATCH,
        observations_count=worker.FRAMES, observation_stacking=1, hidden_state_size=8,
        state_features=8, pretraining_steps=0)
    Configuration(config=config).check_config(check_data_root=False)
    return config


JAX_SPEC = dict(mode="train", steps=2, pretraining_steps=0, numpy_noise=True)


def jax_train_steps(jax_weights, record: dict) -> list:
    """The JAX trainer's one-device train step on the global batch, from the
    same weights with the same numpy noise and schedules as each step of a
    rank's ``record`` of ``JAX_SPEC``: each step's metrics and state."""
    model, variables, vgg_variables = jax_weights
    jax_tr = jax_trainer.Trainer(_jax_config(), model, NullDataset(), Logger(),
                                 smooth_mi=True, vgg_variables=vgg_variables)
    step = jax_tr._make_train_step(False)
    state = JaxTrainState(params=variables["params"],
                          opt_state=jax_tr.tx.init(variables["params"]),
                          batch_stats=variables["batch_stats"],
                          model_state=variables["model_state"],
                          mi_matrix=jax_losses.init_mi_matrix(worker.ACTIONS),
                          step=jnp.zeros((), jnp.int32))
    obs, acts = worker.global_batch()
    runs = []
    with patched_noise():
        for step_record in record["steps"]:
            NOISE.reset()
            state, metrics = step(
                state, jnp.asarray(obs), jnp.asarray(acts),
                jnp.asarray(step_record["metrics"]["ground_truth_observations"], jnp.int32),
                jnp.asarray(step_record["metrics"]["gumbel_temperature"], jnp.float32),
                jax.random.PRNGKey(0), jax_tr.vgg_variables)
            metrics.pop("_plot_arrays")
            runs.append(dict(metrics=jax.device_get(metrics), state=jax.device_get(state)))
    return runs


def assert_matches_jax_steps(rank: dict, runs: list) -> None:
    """The first step's loss, gradient norms, parameter updates (within
    Adam's sensitivity to the gradients' agreement, as
    test_torch_train.test_one_adam_step_matches_jax_train_step bounds
    them), BatchNorm statistics, centroids and MI matrix; both steps'
    losses."""
    run = runs[0]
    got, initial = rank["steps"][0]["state"], rank["initial"]
    training = worker.tiny_config(0)["training"]
    eps = 1e-8
    for path, value in _leaves(run["state"].params):
        key, value = _convert("params", path, value)
        before = initial["model"][key].numpy()
        delta_got, delta_want = got["model"][key].numpy() - before, value - before
        g = np.abs(got["grads"][key].numpy() + training["weight_decay"] * before)
        delta = 2e-3 * g + 1e-4 * g.max() + GRADIENT_NOISE
        slope = eps / (np.maximum(g - delta, 0) + eps) ** 2
        bound = LR * delta * slope + 2 * np.spacing(np.abs(before).max())
        excess = np.abs(delta_got - delta_want) - bound
        assert excess.max() <= 0, (key, excess.max())
    for collection in ("batch_stats", "model_state"):
        for path, value in _leaves(getattr(run["state"], collection)):
            key, value = _convert(collection, path, value)
            np.testing.assert_allclose(got["model"][key].numpy(), value, err_msg=key, **TOL)
    np.testing.assert_allclose(got["mi_matrix"].numpy(), run["state"].mi_matrix, **TOL)
    norms = [k for k in run["metrics"] if k.startswith("grad_norm/")]
    assert len(norms) == 6
    for key in norms + ["loss"]:
        np.testing.assert_allclose(rank["steps"][0]["metrics"][key], run["metrics"][key],
                                   rtol=2e-3, err_msg=key)
    np.testing.assert_allclose([s["metrics"]["loss"] for s in rank["steps"]],
                               [float(r["metrics"]["loss"]) for r in runs], **TOL)


@pytest.fixture(scope="module")
def jax_and_two_ranks(jax_weights, tmp_path_factory):
    """Two full-phase steps: two ranks with the JAX weights and the same
    numpy noise, drawn for the global batch in each rank, and the JAX
    trainer's one-device train step on the global batch."""
    ranks = run_ranks(tmp_path_factory.mktemp("jax_parity"),
                      dict(JAX_SPEC, variables=jax_weights[1]), 2)
    return ranks, jax_train_steps(jax_weights, ranks[0])


def test_two_ranks_match_the_jax_train_step(jax_and_two_ranks):
    """``assert_matches_jax_steps`` on rank 0."""
    ranks, runs = jax_and_two_ranks
    assert_matches_jax_steps(ranks[0], runs)


# --------------------------------------------------------------------- #
# The loader's rows, the torchrun environment and the trainer's checks  #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("nodes,local_world", [(1, 2), (2, 2), (2, 4)])
def test_loader_rows_split_the_jax_node_shard(synthetic_dataset_dir, nodes, local_world):
    """Each rank's rows, concatenated in local-rank order, are the batch
    that the JAX DataLoader gives the node's process (shard node::nodes of
    the same-seed shuffle)."""
    config = _jax_config()
    batching = dict(config["training"]["batching"], observations_count=3)
    path = os.path.join(synthetic_dataset_dir, "train")
    jax_dataset = JaxVideoDataset(path, batching, make_train_transform(None, (32, 32)))
    port_config = dict(config, model=dict(config["model"], representation_network=dict(
        config["model"]["representation_network"], target_input_size=[32, 32])))
    dataset = VideoDataset(path, batching, get_final_transforms(port_config)["train"])
    for node in range(nodes):
        want = list(JaxDataLoader(jax_dataset, batch_size=4, seed=7, num_workers=1,
                                  shard_index=node, shard_count=nodes))
        got = [list(DataLoader(dataset, batch_size=4, seed=7, num_workers=1,
                               shard_index=node, shard_count=nodes, local_rank=rank,
                               local_world=local_world))
               for rank in range(local_world)]
        assert want and all(len(g) == len(want) for g in got)
        for i, batch in enumerate(want):
            for name in ("observations", "actions"):
                rows = np.concatenate([getattr(g[i], name) for g in got])
                np.testing.assert_array_equal(rows, getattr(batch, name), err_msg=name)
    with pytest.raises(ValueError, match="does not split"):
        DataLoader(dataset, batch_size=4, local_world=3)


def test_init_distributed_reads_the_torchrun_environment(monkeypatch, tmp_path):
    """Without torchrun's environment: a world of one and no group.  With
    it, no fallback: a partial environment, a missing GPU, a rank whose GPU
    is not there and NCCL without a group it can form each raise.  (The
    ranks of the runs above read a full environment: ``process`` in their
    results.)"""
    for key in mesh.TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    assert mesh.init_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert mesh.process_info() == mesh.ProcessInfo()
    assert (mesh.ProcessInfo(5, 8, 1, 4).node, mesh.ProcessInfo(5, 8, 1, 4).nodes) == (1, 2)

    monkeypatch.setenv("RANK", "1")
    with pytest.raises(RuntimeError, match="partial torchrun environment"):
        mesh.init_distributed("cpu")
    for key, value in (("WORLD_SIZE", "2"), ("LOCAL_RANK", "1"), ("LOCAL_WORLD_SIZE", "2")):
        monkeypatch.setenv(key, value)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.init_distributed("cuda")
    with monkeypatch.context() as gpu:
        gpu.setattr(torch.cuda, "is_available", lambda: True)
        gpu.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(RuntimeError, match="LOCAL_RANK 1 needs GPU 1"):
            mesh.init_distributed("cuda")
        with pytest.raises(RuntimeError, match="LOCAL_RANK 1 needs GPU 2"):
            mesh.init_distributed("cuda:2")
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                       ("LOCAL_WORLD_SIZE", "1")):
        monkeypatch.setenv(key, value)
    with pytest.raises((RuntimeError, ValueError)):
        mesh.init_distributed("cpu", backend="nccl", init_method=f"file://{tmp_path}/init")
    assert not torch.distributed.is_initialized()


def test_trainer_refuses_what_it_cannot_honour():
    """A tpu.model_parallel that does not divide the world (one rank,
    without a group) is the JAX make_mesh's "does not cover";
    tpu.data_parallel_devices must be the world (one, without a group)."""
    config = worker.tiny_config(0)
    model = make_model(config, "cpu", worker.MODEL_SEED)
    vgg = make_vgg("cpu", seed=worker.VGG_SEED)
    config["tpu"]["model_parallel"] = 2
    with pytest.raises(ValueError, match="does not cover 1 rank"):
        Trainer(config, model, vgg=vgg)
    config["tpu"].update(model_parallel=1, data_parallel_devices=2)
    with pytest.raises(ValueError, match="data_parallel_devices is 2"):
        Trainer(config, model, vgg=vgg)
    config["tpu"]["data_parallel_devices"] = 1
    assert Trainer(config, model, vgg=vgg).process == mesh.ProcessInfo()
