"""Tensor parallelism of the port (``tpu.model_parallel``) on the CPU, and
``tpu.data_parallel_devices`` counted over every node.

Ranks are subprocesses of tests/torch_parallel_worker.py joined over gloo,
as in tests/test_torch_parallel.py, on the same tiny model (16x16 frames,
hidden 8, 3 actions, a global batch of 4 sequences of 3 frames) with
``tp_min_channels`` 8, the tiny model's setting in
``__graft_entry__.dryrun_multichip``: nearly every kernel is sharded.  A
rank at ``r`` sits at data index ``r // 2`` and model index ``r % 2``.

Tolerances: a mesh against one process takes the dryrun's
(``assert_dryrun_close``: the loss within 1e-3 relative, the parameters
rtol 2e-3 and atol 4 lr, the BatchNorm statistics, centroids and MI matrix
rtol 2e-3 and atol lr) after each step, and the first step's diagnostics
and gradient norms rtol 2e-3; against the JAX package's one-device train
step, ``assert_matches_jax_steps``'s (GSPMD's tensor parallelism computes
the same function, so one device is the reference).  The column-parallel
layers in f32 against the unsharded ones: rtol 1e-6 (the conv on a slice
of the output channels and the two partial input gradients summed
reassociate a few roundings).  Replicated state, checkpoints and resumes:
bit for bit.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_parallel_worker as worker
from test_torch_parallel import (  # noqa: F401 (jax_weights is a fixture)
    JAX_SPEC, REPO, assert_dryrun_close, assert_matches_jax_steps, assert_same_state,
    jax_train_steps, jax_weights, run_ranks)
from torch_parity import single_threaded_torch  # noqa: F401 (an autouse fixture)

from playablevideogeneration_tpu_torch.data.loader import DataLoader
from playablevideogeneration_tpu_torch.data.transforms import get_final_transforms
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset
from playablevideogeneration_tpu_torch.models import layers
from playablevideogeneration_tpu_torch.models.caddy import Caddy, make_model
from playablevideogeneration_tpu_torch.models.vgg import make_vgg
from playablevideogeneration_tpu_torch.parallel import mesh
from playablevideogeneration_tpu_torch.training.trainer import Trainer
from playablevideogeneration_tpu_torch.utils.checkpoint import restore_checkpoint
from playablevideogeneration_tpu_torch.utils.jax_weights import _convert, load_jax_variables

TP = dict(model_parallel=2, tp_min_channels=8)
# A pretraining step, then a full-phase step, with per-step activation
# checkpointing: the recompute gathers the sharded convs' outputs again.
TRAIN_SPEC = dict(mode="train", steps=2, pretraining_steps=1, remat=True)


# --------------------------------------------------------------------- #
# The sharded set against the JAX package's param_shardings              #
# --------------------------------------------------------------------- #

# Runs in a process with two CPU devices, the 1 x 2 mesh that
# param_shardings needs; the models' variables are only traced.
JAX_SELECTION = """
import json, sys
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from __graft_entry__ import _flagship_model
from playablevideogeneration_tpu.data.synthetic import make_synthetic_config
from playablevideogeneration_tpu.models.caddy import init_model_variables, make_model
from playablevideogeneration_tpu.parallel import mesh as mesh_lib

def selection(model, size, min_channels):
    batch = (jnp.zeros((2, 2, size, size, 3)), jnp.zeros((2, 2), jnp.int32))
    variables = jax.eval_shape(
        lambda: init_model_variables(model, jax.random.PRNGKey(0), *batch))
    shardings = mesh_lib.param_shardings(
        mesh_lib.make_mesh(jax.devices()[:2], model_parallel=2), variables["params"],
        min_channels)
    leaves = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    specs = jax.tree_util.tree_leaves(shardings)
    return [[[k.key for k in path], list(leaf.shape)]
            for (path, leaf), sharding in zip(leaves, specs) if sharding.spec != P()]

tiny = make_model(make_synthetic_config(
    data_root="", output_root="", height=16, width=16, actions_count=3, batch_size=4,
    observations_count=3, observation_stacking=1, hidden_state_size=8, state_features=8))
json.dump({"tiny": selection(tiny, 16, 8),
           "flagship": selection(_flagship_model(), 256, 256)}, sys.stdout)
"""


@pytest.fixture(scope="module")
def jax_selection():
    """JAX's sharded kernels of the tiny model at tp_min_channels 8 and of
    the flagship at 256, as port state names with their port shapes."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    out = subprocess.run([sys.executable, "-c", JAX_SELECTION], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]

    def port_name(path, shape):
        name, value = _convert("params", tuple(path), np.zeros(shape, np.float32))
        return name, value.shape

    return {size: dict(port_name(*kernel) for kernel in kernels)
            for size, kernels in json.loads(out.stdout).items()}


def port_models() -> dict:
    """The port's tiny model and, on the meta device, its flagship."""
    with torch.device("meta"):
        flagship = Caddy(actions_count=7, action_space_dimension=2, state_features=64,
                         state_resolution=(32, 32), hidden_state_size=128,
                         observation_stacking=1, dtype=torch.bfloat16)
    return {"tiny": (make_model(worker.tiny_config(0), "cpu", worker.MODEL_SEED), 8),
            "flagship": (flagship, 256)}


@pytest.mark.parametrize("size", ["tiny", "flagship"])
def test_sharded_layers_are_the_jax_param_shardings_selection(jax_selection, size):
    """``layers.tensor_parallel_layers`` at a model axis of 2 selects the
    kernels that the JAX package's ``param_shardings`` shards, with their
    shapes: at the flagship's 256 the three ConvLSTM gate convolutions and
    the dynamics network's 256-wide convolutions among them."""
    model, min_channels = port_models()[size]
    parameters = dict(model.named_parameters())
    got = {f"{name}.weight": tuple(parameters[f"{name}.weight"].shape)
           for name in layers.tensor_parallel_layers(model, 2, min_channels)}
    want = jax_selection[size]
    assert got == want
    assert not layers.tensor_parallel_layers(model, 1, min_channels)
    if size == "flagship":
        gates = {k for k in got if k.endswith("cell.gates.weight")}
        assert len(gates) == 3
        assert {got[k][0] for k in gates} == {512, 1024}


# --------------------------------------------------------------------- #
# The column-parallel layers against the unsharded ones                  #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def tp_units(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("tp_units"), dict(mode="tp_units",
                                                               model_parallel=2), 2)


@pytest.mark.parametrize("layer", ["conv", "dense", "odd"])
def test_column_parallel_layer_matches_the_unsharded_one(tp_units, layer):
    """Output, input gradient, weight-slice gradient and bias gradient in
    f32 on each of two ranks against the unsharded layer (rtol 1e-6); a
    conv of 9 output channels, which 2 does not divide, is replicated and
    computes as the plain layer, bit for bit.  The unsharded copy holds the
    original weights bit for bit."""
    for rank, result in enumerate(tp_units):
        assert result["sharded"] == ["conv", "dense"]
        plain, sharded = result[f"{layer}/plain"], result[f"{layer}/sharded"]
        rows = slice(rank * 4, (rank + 1) * 4) if layer != "odd" else slice(None)
        for key, want in plain.items():
            got = sharded[key]
            want = want[rows] if key == "weight_grad" else want
            if layer == "odd":
                assert torch.equal(got, want), key
            else:
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6,
                                           err_msg=f"rank {rank} {layer} {key}")
        for name in ("weight", "bias"):
            key = f"{layer}.{name}"
            assert torch.equal(result["unsharded_copy"][key], result["plain_state"][key]), key


# --------------------------------------------------------------------- #
# 1 x 2 and 2 x 2 meshes against one process                             #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def one_process():
    return worker.train(TRAIN_SPEC)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """A pretraining and a full-phase step on a 1 x 2 and a 2 x 2 mesh."""
    return {shape: run_ranks(tmp_path_factory.mktemp(f"mesh_{shape}"),
                             dict(TRAIN_SPEC, tpu=dict(TP, grad_histograms=True)), world)
            for shape, world in (("1x2", 2), ("2x2", 4))}


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_mesh_holds_one_state_on_every_rank(meshes, shape):
    """Every rank's state (the sharded tensors gathered, the replicated
    ones as they are), metrics and gradient histograms are the same bit for
    bit after each step: the ranks of a model group compute the replicated
    state alike, and the data groups average the same slices; each data
    index trains on its rows of the global batch."""
    ranks = meshes[shape]
    world = len(ranks)
    assert [r["process"] for r in ranks] == [mesh.ProcessInfo(r, world, r, world)
                                             for r in range(world)]
    assert ranks[0]["sharded"] and all(r["sharded"] == ranks[0]["sharded"] for r in ranks)
    observations, _ = worker.global_batch()
    rows = worker.BATCH // (world // 2)
    for index, rank in enumerate(ranks):
        data_index = index // 2
        np.testing.assert_array_equal(rank["batch"][0],
                                      observations[data_index * rows:(data_index + 1) * rows])
        for got, want in zip(rank["steps"], ranks[0]["steps"], strict=True):
            assert got["metrics"] == want["metrics"]
            assert_same_state(got["state"], want["state"])
            for name, (counts, edges) in want["histograms"].items():
                np.testing.assert_array_equal(got["histograms"][name][0], counts)
                np.testing.assert_array_equal(got["histograms"][name][1], edges)


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_gradient_histograms_count_every_full_gradient(meshes, shape):
    """tpu.grad_histograms gathers the sharded gradients first: each
    module's histogram counts every element of its full gradients."""
    for step in meshes[shape][0]["steps"]:
        sizes = {}
        for name, grad in step["state"]["grads"].items():
            module = name.split(".")[0]
            sizes[module] = sizes.get(module, 0) + grad.numel()
        assert {key.removeprefix("_grad_hist/"): int(counts.sum())
                for key, (counts, _) in step["histograms"].items()} == sizes


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
@pytest.mark.parametrize("step", [0, 1])
def test_mesh_matches_one_process(meshes, one_process, shape, step):
    """After the pretraining step (0) and the full-phase step (1): the
    gathered parameters, the BatchNorm statistics, centroids and MI matrix
    at the dryrun's tolerances of the one-process trainer's on the whole
    batch; the first step's diagnostics and gradient norms (a sharded
    slice's squared norm summed over the model group) within rtol 2e-3."""
    got, want = meshes[shape][0]["steps"][step], one_process["steps"][step]
    assert got["metrics"]["pretraining"] == want["metrics"]["pretraining"] == float(step == 0)
    assert_dryrun_close(got, want)
    if step == 0:
        assert got["metrics"].keys() == want["metrics"].keys()
        for key, value in want["metrics"].items():
            atol = 0.0 if key.startswith("grad_norm/") else 1e-5
            np.testing.assert_allclose(got["metrics"][key], value, rtol=2e-3, atol=atol,
                                       err_msg=key)


def test_one_by_two_mesh_matches_the_jax_train_step(jax_weights, tmp_path):
    """Two full-phase steps on a 1 x 2 mesh from the JAX weights, with the
    same numpy noise, against the JAX package's one-device train step
    (``assert_matches_jax_steps``)."""
    ranks = run_ranks(tmp_path, dict(JAX_SPEC, variables=jax_weights[1], tpu=TP), 2)
    assert_matches_jax_steps(ranks[0], jax_train_steps(jax_weights, ranks[0]))


# --------------------------------------------------------------------- #
# Two one-rank nodes, checkpoints and elastic resume                     #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def two_nodes(synthetic_dataset_dir, tmp_path_factory):
    """Two nodes of one rank each (``LOCAL_WORLD_SIZE`` 1) with
    ``tpu.data_parallel_devices`` 2, each on the first batch its trainer's
    loader gives from the synthetic dataset: a pretraining and a
    full-phase step, then ``latest`` saved."""
    root = str(tmp_path_factory.mktemp("two_nodes"))
    ranks = run_ranks(root, dict(TRAIN_SPEC, dataset=os.path.join(synthetic_dataset_dir,
                                                                  "train"),
                                 tpu=dict(data_parallel_devices=2), save_root=root,
                                 save="latest"), 2, local_world=1)
    return ranks, root


def test_two_one_rank_nodes_match_one_process_on_their_shards(two_nodes,
                                                              synthetic_dataset_dir):
    """Each node's rank loads its node's shard of the epoch (the loader
    with ``shard_index`` its node of 2), and the two nodes train as one
    process on the two shards' batches concatenated: the dryrun's
    tolerances after each step, the first step's metrics rtol 2e-3."""
    ranks, _ = two_nodes
    assert [r["process"] for r in ranks] == [mesh.ProcessInfo(0, 2, 0, 1),
                                             mesh.ProcessInfo(1, 2, 0, 1)]
    config = worker.tiny_config(0)
    batching = dict(config["training"]["batching"], observations_count=worker.FRAMES)
    dataset = VideoDataset(os.path.join(synthetic_dataset_dir, "train"), batching,
                           get_final_transforms(config)["train"])
    for node, rank in enumerate(ranks):
        (want, *_) = DataLoader(dataset, batch_size=worker.BATCH, seed=0, num_workers=1,
                                shard_index=node, shard_count=2)
        np.testing.assert_array_equal(rank["batch"][0], want.observations)
        np.testing.assert_array_equal(rank["batch"][1], want.actions)
    batch = tuple(np.concatenate([r["batch"][i] for r in ranks]) for i in range(2))
    one = worker.train(dict(TRAIN_SPEC, batch=batch))
    for got, want in zip(ranks[0]["steps"], one["steps"], strict=True):
        assert_dryrun_close(got, want)
    for key, value in one["steps"][0]["metrics"].items():
        np.testing.assert_allclose(ranks[0]["steps"][0]["metrics"][key], value, rtol=2e-3,
                                   atol=0.0 if key.startswith("grad_norm/") else 1e-5,
                                   err_msg=key)
    assert ranks[0]["steps"][-1]["metrics"] == ranks[1]["steps"][-1]["metrics"]


def assert_resumed(got: dict, want: dict) -> None:
    """A resumed snapshot equals the saved state bit for bit."""
    for key, value in want["model"].items():
        assert torch.equal(got["model"][key], value), key
    assert got["adam"].keys() == want["adam"].keys()
    for name, slots in want["adam"].items():
        for key, value in slots.items():
            assert torch.equal(got["adam"][name][key], value), (name, key)
    assert torch.equal(got["mi_matrix"], want["mi_matrix"])
    assert got["step"] == want["step"]


@pytest.fixture(scope="module")
def resumed_on_one_by_two(two_nodes, tmp_path_factory):
    """The two nodes' (data-parallel) checkpoint resumed on a 1 x 2 mesh,
    one full-phase step, then saved as ``from_1x2``."""
    _, root = two_nodes
    return run_ranks(tmp_path_factory.mktemp("resume_1x2"),
                     dict(TRAIN_SPEC, steps=1, tpu=TP, save_root=root, resume="latest",
                          save="from_1x2"), 2)


def test_data_parallel_checkpoint_resumes_on_one_by_two(two_nodes, resumed_on_one_by_two):
    """Each rank of the 1 x 2 mesh holds the data-parallel state bit for
    bit after the load (its slices gathered back), then takes a finite
    full-phase step; only rank 0 writes the 1 x 2 checkpoint."""
    want = two_nodes[0][0]["steps"][-1]["state"]
    for rank in resumed_on_one_by_two:
        assert rank["sharded"]
        assert_resumed(rank["resumed"], want)
        assert np.isfinite(rank["steps"][0]["metrics"]["loss"])
        assert rank["steps"][0]["metrics"]["pretraining"] == 0.0
    assert resumed_on_one_by_two[0]["checkpoint_writes"] == [
        os.path.join(two_nodes[1], "from_1x2")]
    assert resumed_on_one_by_two[1]["checkpoint_writes"] == []


def assert_same_tree(got, want, path="") -> None:
    """Two checkpoint trees: the same keys and values, tensors bit for
    bit."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for key in want:
            assert_same_tree(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), path
    else:
        assert got == want, path


def test_one_by_two_checkpoint_resumes_in_one_process(two_nodes, resumed_on_one_by_two):
    """The 1 x 2 checkpoint holds full tensors: one process resumes it bit
    for bit and, saving at once, writes the same checkpoint tensor for
    tensor; it then takes a finite step."""
    root = two_nodes[1]
    saved = worker.train(dict(TRAIN_SPEC, steps=0, save_root=root, resume="from_1x2",
                              save="from_one"))
    assert_resumed(saved["resumed"], resumed_on_one_by_two[0]["steps"][-1]["state"])
    assert_same_tree(restore_checkpoint(os.path.join(root, "from_one")),
                     restore_checkpoint(os.path.join(root, "from_1x2")))
    stepped = worker.train(dict(TRAIN_SPEC, steps=1, save_root=root, resume="from_1x2"))
    assert np.isfinite(stepped["steps"][0]["metrics"]["loss"])


# --------------------------------------------------------------------- #
# The trainer's mesh, loader rows and refusals                           #
# --------------------------------------------------------------------- #

def trainer_under(monkeypatch, process: mesh.ProcessInfo, dataset=None, **tpu) -> Trainer:
    """A trainer built as the rank ``process`` describes, groups recorded
    instead of made (``dist.new_group`` returns its ranks)."""
    monkeypatch.setattr(mesh, "process_info", lambda: process)
    monkeypatch.setattr(torch.distributed, "new_group", tuple)
    config = worker.tiny_config(0, **tpu)
    return Trainer(config, make_model(config, "cpu", worker.MODEL_SEED),
                   vgg=make_vgg("cpu", seed=worker.VGG_SEED), dataset=dataset)


def test_data_parallel_devices_counts_the_ranks_of_every_node(monkeypatch):
    """As the JAX package counts devices over every process: on two nodes
    of one rank, 2 and not 1; on a world of 4 with tpu.model_parallel 2,
    2 data indices and not 4."""
    assert trainer_under(monkeypatch, mesh.ProcessInfo(0, 2, 0, 1),
                         data_parallel_devices=2).mesh.data_size == 2
    with pytest.raises(ValueError, match="data_parallel_devices is 1 .* 2 rank"):
        trainer_under(monkeypatch, mesh.ProcessInfo(0, 2, 0, 1), data_parallel_devices=1)
    trainer = trainer_under(monkeypatch, mesh.ProcessInfo(0, 4, 0, 4),
                            data_parallel_devices=2, **TP)
    assert (trainer.mesh.data_size, trainer.mesh.model_size) == (2, 2)
    with pytest.raises(ValueError, match="data_parallel_devices is 4 .* 4 rank"):
        trainer_under(monkeypatch, mesh.ProcessInfo(0, 4, 0, 4), data_parallel_devices=4,
                      **TP)


@pytest.mark.parametrize("rank", range(4))
def test_mesh_of_four_ranks_places_each_rank_and_its_rows(monkeypatch, rank):
    """Rank r of a 2 x 2 mesh sits at data index r // 2 and model index
    r % 2, as the JAX device grid's reshape; every rank makes the model
    groups, then the data groups, in one order; a node's loader gives the
    ranks of a model group the same rows of its batch."""
    trainer = trainer_under(monkeypatch, mesh.ProcessInfo(rank, 4, rank, 4), dataset=[], **TP)
    info = trainer.mesh
    assert (info.data_index, info.model_index) == (rank // 2, rank % 2)
    assert info.model_group == ((0, 1), (2, 3))[rank // 2]
    assert info.data_group == ((0, 2), (1, 3))[rank % 2]
    assert trainer.dataloader.rows == slice(2 * (rank // 2), 2 * (rank // 2) + 2)
    calls = []
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks: calls.append(ranks))
    mesh.make_mesh(mesh.ProcessInfo(rank, 4, rank, 4), 2)
    assert calls == [[0, 1], [2, 3], [0, 2], [1, 3]]


@pytest.mark.parametrize("process,match", [
    (mesh.ProcessInfo(0, 3, 0, 3), "does not cover 3 rank"),
    (mesh.ProcessInfo(0, 4, 0, 1), "does not divide the 1 rank"),
])
def test_trainer_refuses_a_mesh_that_model_parallel_does_not_fit(monkeypatch, process,
                                                                 match):
    """A world that tpu.model_parallel does not divide, and a node whose
    ranks it does not divide (a JAX process holds whole rows of the
    mesh)."""
    with pytest.raises(ValueError, match=match):
        trainer_under(monkeypatch, process, **TP)


def test_sharding_changes_nothing_at_one_rank_and_refuses_a_full_load(monkeypatch):
    """At a model axis of one rank ``shard_model`` replaces no layer; a
    sharded model refuses the full-size weights of the JAX layout."""
    model = make_model(worker.tiny_config(0), "cpu", worker.MODEL_SEED)
    before = {name: type(m) for name, m in model.named_modules()}
    assert layers.shard_model(model, mesh.MeshInfo(), 8) == []
    assert {name: type(m) for name, m in model.named_modules()} == before
    full = {k: v.clone() for k, v in model.state_dict().items()}
    info = mesh.MeshInfo(mesh.ProcessInfo(1, 2, 1, 2), 2)
    names = layers.shard_model(model, info, 8)
    assert names and all(isinstance(model.get_submodule(n), layers.ColumnParallel)
                         for n in names)
    for name in names:
        weight = full[f"{name}.weight"]
        rows = weight.shape[0] // 2
        assert torch.equal(model.get_submodule(name).weight, weight[rows:])
    jax_tree = {"params": {}}
    node = jax_tree["params"]
    *path, leaf = f"{names[0]}.kernel".split(".")
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = full[f"{names[0]}.weight"].permute(2, 3, 1, 0).numpy()
    with pytest.raises(ValueError, match="expects"):
        load_jax_variables(model, jax_tree)
