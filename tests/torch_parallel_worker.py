"""One rank of the port's data- and tensor-parallel runs in
tests/test_torch_parallel.py and tests/test_torch_tensor_parallel.py.

Run as ``python tests/torch_parallel_worker.py <spec.pkl>`` with torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``)
set: the rank joins a gloo group on the CPU through the spec's
``init_method`` (``file://`` in the test's temporary directory), runs the
spec's ``mode`` on its rows of the global batch and writes what it
computed to ``spec["output"] % rank`` with ``torch.save``.  The test calls
the same functions in its own process, with no group, for the one-process
reference.

The model is tiny, as tests/multihost_worker.py's: 16x16 frames, hidden
and state features 8, 3 actions, a global batch of 4 sequences of 3
frames.
"""
import contextlib
import copy
import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from playablevideogeneration_tpu_torch.data.transforms import get_final_transforms  # noqa: E402
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset  # noqa: E402
from playablevideogeneration_tpu_torch.models import action as port_action  # noqa: E402
from playablevideogeneration_tpu_torch.models import layers  # noqa: E402
from playablevideogeneration_tpu_torch.models import caddy as port_caddy  # noqa: E402
from playablevideogeneration_tpu_torch.models.centroids import update_centroids  # noqa: E402
from playablevideogeneration_tpu_torch.models.gumbel import gumbel_softmax  # noqa: E402
from playablevideogeneration_tpu_torch.models.layers import BatchNorm  # noqa: E402
from playablevideogeneration_tpu_torch.models.vgg import make_vgg  # noqa: E402
from playablevideogeneration_tpu_torch.parallel import mesh  # noqa: E402
from playablevideogeneration_tpu_torch.training import losses  # noqa: E402
from playablevideogeneration_tpu_torch.training.bench_harness import (  # noqa: E402
    make_synthetic_config,
)
from playablevideogeneration_tpu_torch.training.trainer import Trainer  # noqa: E402
from playablevideogeneration_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables  # noqa: E402

SIZE, FRAMES, BATCH, ACTIONS = 16, 3, 4, 3
MODEL_SEED, VGG_SEED = 3, 4


def tiny_config(pretraining_steps: int, remat: bool = False, save_root: str = "",
                **tpu) -> dict:
    """The tiny model's config; ``tpu`` entries (``model_parallel``,
    ``tp_min_channels``, ``data_parallel_devices``) join its ``tpu``
    block."""
    config = make_synthetic_config(
        height=SIZE, width=SIZE, actions_count=ACTIONS, batch_size=BATCH,
        observations_count=FRAMES, observation_stacking=1, hidden_state_size=8,
        state_features=8, pretraining_steps=pretraining_steps, remat=remat)
    config["logging"]["save_root_directory"] = save_root
    config["tpu"].update(tpu)
    return config


def global_batch(seed: int = 6):
    """(observations (B, T, H, W, 3) in [-1, 1], actions (B, T))."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (BATCH, FRAMES, SIZE, SIZE, 3)).astype(np.float32),
            rng.integers(0, ACTIONS, (BATCH, FRAMES)).astype(np.int32))


def rows(array, model_parallel: int = 1):
    """This rank's data index's contiguous rows of a global array."""
    info = mesh.MeshInfo(mesh.process_info(), model_parallel)
    n = len(array) // info.data_size
    return array[info.data_index * n:(info.data_index + 1) * n]


def numpy_noise():
    """tests/torch_parity.py's numpy noise in call order, for the port's
    action networks and Gumbel sampler: each draw made for the global batch
    and this rank's rows kept.  Returns (source, reparameterized sample,
    Gumbel sample)."""
    from torch_parity import NOISE

    def draw(kind):
        return lambda shape: torch.from_numpy(NOISE.draw(tuple(shape), kind))

    def reparameterized(generator, mean, variance):
        return mesh.global_rows(draw("normal"), mean.shape) * torch.sqrt(variance) + mean

    def gumbel(generator, log_probs, temperature, hard=False):
        noise = mesh.global_rows(draw("gumbel"), log_probs.shape)
        return gumbel_softmax(log_probs, noise, temperature, hard)

    return NOISE, reparameterized, gumbel


def snapshot(trainer: Trainer) -> dict:
    """The training state and the step's averaged gradients, copied, in
    full tensors (a sharded parameter's, its moments' and its gradient's
    slices gathered over the model group)."""
    state = trainer.state.state_dict()
    names = [name for name, _ in trainer.model.named_parameters()]
    sharded = layers.sharded_layers(trainer.model)
    return dict(
        model={k: v.detach().clone() for k, v in state["model"].items()},
        adam={names[i]: {k: v.clone() for k, v in slots.items()}
              for i, slots in state["optimizer"]["state"].items()},
        grads={name: sharded[name].gather(p.grad) if name in sharded else p.grad.clone()
               for name, p in trainer.model.named_parameters() if p.grad is not None},
        mi_matrix=trainer.state.mi_matrix.clone(), step=trainer.state.step)


def train(spec: dict) -> dict:
    """``spec["steps"]`` train steps of the smooth-MI trainer on this rank's
    data index's rows of the global batch (or of ``spec["batch"]``, or the
    first batch the trainer's loader gives from the dataset at
    ``spec["dataset"]``): the model seeded, or from ``variables`` (the JAX
    layout); ``spec["tpu"]`` joins the config's ``tpu`` block; optionally
    resumed from the checkpoint ``resume`` first and saved as ``save``
    after.  Returns the metrics, gradient histograms and state of every
    step (and of the resumed state), the batch and the sharded layers."""
    tpu = spec.get("tpu", {})
    config = tiny_config(spec["pretraining_steps"], spec.get("remat", False),
                         spec.get("save_root", ""), **tpu)
    model = port_caddy.make_model(config, "cpu", MODEL_SEED)
    if spec.get("variables") is not None:
        load_jax_variables(model, spec["variables"])
    dataset = None
    if spec.get("dataset"):
        batching = dict(config["training"]["batching"], observations_count=FRAMES)
        dataset = VideoDataset(spec["dataset"], batching,
                               get_final_transforms(config)["train"])
    trainer = Trainer(config, model, smooth_mi=True, vgg=make_vgg("cpu", seed=VGG_SEED),
                      dataset=dataset)
    trainer.init_state()
    result = {"process": mesh.process_info(), "initial": snapshot(trainer),
              "sharded": list(layers.sharded_layers(model))}
    if spec.get("resume"):
        trainer.load_checkpoint(spec["resume"])
        result["resumed"] = snapshot(trainer)
    if dataset is not None:
        batch = list(trainer.dataloader)[0]
    else:
        observations, actions = spec.get("batch") or global_batch()
        m = tpu.get("model_parallel", 1)
        batch = type("Batch", (), dict(observations=rows(observations, m),
                                       actions=rows(actions, m)))
    result["batch"] = (batch.observations, batch.actions)
    noise = None
    saved = port_action.reparameterized_sample, port_caddy.gumbel_softmax_sample
    if spec.get("numpy_noise"):
        noise, port_action.reparameterized_sample, port_caddy.gumbel_softmax_sample = (
            numpy_noise())
    try:
        steps = []
        for _ in range(spec["steps"]):
            if noise is not None:
                noise.reset()
            metrics = trainer.train_step(batch)
            histograms = {k: metrics.pop(k) for k in list(metrics) if k.startswith("_grad_hist/")}
            steps.append(dict(metrics=metrics, state=snapshot(trainer), histograms=histograms))
    finally:
        port_action.reparameterized_sample, port_caddy.gumbel_softmax_sample = saved
    if spec.get("save"):
        # Records which ranks write the file.
        writes, write = [], ckpt_lib.save_checkpoint
        ckpt_lib.save_checkpoint = lambda path, state: (writes.append(path), write(path, state))
        try:
            trainer.save_checkpoint(spec["save"])
        finally:
            ckpt_lib.save_checkpoint = write
        result["checkpoint_writes"] = writes
    result["steps"] = steps
    return result


def units(spec: dict) -> dict:
    """Train-mode BatchNorm's output, input gradient, parameter gradients
    and running statistics; the MI and smooth-MI losses with their input
    gradients and the new MI matrix; the centroid update: each on this
    rank's rows inside a data-parallel step (or on the whole batch with no
    group)."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(1.0, 2.0, (8, 5, 6, 7)).astype(np.float32))
    cotangent = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    p1 = torch.softmax(torch.from_numpy(rng.normal(size=(12, ACTIONS)).astype(np.float32)), -1)
    p2 = torch.softmax(torch.from_numpy(rng.normal(size=(12, ACTIONS)).astype(np.float32)), -1)
    mi_matrix = torch.softmax(torch.from_numpy(rng.normal(size=ACTIONS * ACTIONS)), 0)
    mi_matrix = mi_matrix.float().view(ACTIONS, ACTIONS)
    centroids = torch.from_numpy(rng.normal(size=(ACTIONS, 2)).astype(np.float32))
    priors = torch.from_numpy(rng.normal(size=(12, 2, 2)).astype(np.float32))

    norm = BatchNorm(5, activation="leaky_relu").train()
    torch.manual_seed(0)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.normal_()
    x, cotangent = rows(x).clone().requires_grad_(), rows(cotangent)
    p1, p2 = rows(p1).clone().requires_grad_(), rows(p2).clone().requires_grad_()
    grouped = torch.distributed.is_initialized()
    with (mesh.global_batch(mesh.make_mesh(mesh.process_info())) if grouped
          else contextlib.nullcontext()):
        y = norm(x)
        (y * cotangent).sum().backward()
        mi = losses.mutual_information_loss(p1, p2, lamb=0.8)
        smooth, new_matrix = losses.smooth_mutual_information_loss(
            p1, p2, mi_matrix, 0.2, lamb=0.8)
        (mi + 2 * smooth).backward()
        new_centroids = update_centroids(centroids, rows(priors), p1.detach(), 0.1)
    return dict(y=y.detach(), x_grad=x.grad, weight_grad=norm.weight.grad,
                bias_grad=norm.bias.grad, running_mean=norm.running_mean.clone(),
                running_var=norm.running_var.clone(), mi=mi.detach(), smooth=smooth.detach(),
                new_matrix=new_matrix, p1_grad=p1.grad, p2_grad=p2.grad,
                centroids=new_centroids)


def tp_units(spec: dict) -> dict:
    """A 3x3 conv with a bias, a dense layer and a conv whose 9 output
    channels no model axis of 2 divides, in f32: each unsharded, and
    through ``layers.shard_model`` (output channels at least 8) on a model
    group of every rank; forward and backward on the same input and
    cotangent.  Returns, per layer, both outputs, input gradients, weight
    gradients (the sharded one's slice) and bias gradients, the names that
    ``shard_model`` sharded, and the weights of ``layers.unsharded_copy``
    and of the unsharded layers."""
    rng = np.random.default_rng(9)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    torch.manual_seed(0)
    plain = torch.nn.ModuleDict(dict(
        conv=layers.Conv2d(6, 8, 3, True, torch.float32),
        dense=layers.Linear(6, 8, torch.float32),
        odd=layers.Conv2d(6, 9, 3, True, torch.float32)))
    inputs = dict(conv=normal(3, 6, 5, 7), dense=normal(5, 6), odd=normal(3, 6, 5, 7))
    cotangents = dict(conv=normal(3, 8, 5, 7), dense=normal(5, 8), odd=normal(3, 9, 5, 7))
    sharded = copy.deepcopy(plain)
    info = mesh.make_mesh(mesh.process_info(), spec["model_parallel"])
    result = {"sharded": layers.shard_model(sharded, info, 8),
              "unsharded_copy": {k: v.clone() for k, v in
                                 layers.unsharded_copy(sharded).state_dict().items()},
              "plain_state": {k: v.clone() for k, v in plain.state_dict().items()}}
    for name in plain:
        for side, module in (("plain", plain[name]), ("sharded", sharded[name])):
            x = inputs[name].clone().requires_grad_()
            y = module(x)
            (y * cotangents[name]).sum().backward()
            result[f"{name}/{side}"] = dict(y=y.detach(), x_grad=x.grad,
                                            weight_grad=module.weight.grad,
                                            bias_grad=module.bias.grad)
    return result


MODES = {"train": train, "units": units, "tp_units": tp_units}


def main():
    with open(sys.argv[1], "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)
    mesh.init_distributed("cpu", init_method=spec["init_method"])
    try:
        result = MODES[spec["mode"]](spec)
        torch.save(result, spec["output"] % mesh.process_info().rank)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
