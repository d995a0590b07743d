"""Data parallelism over several GPUs with ``torch.distributed``.

Counterpart of the data-parallel half of
``playablevideogeneration_tpu/parallel/mesh.py`` and of
``utils/jax_setup.py``'s ``setup_multihost`` and ``process_info``.  The JAX
train step is written over the *global* batch and GSPMD shards it, so
every reduction over the batch spans all devices and the noise is drawn
for the global array.  Here each rank runs the step on its rows of the
global batch, and the code that reduces over the batch asks this module:

- ``all_reduce_sum``: a differentiable sum over the ranks (train-mode
  BatchNorm's sums of x and x^2, the mutual-information joint matrix);
- ``sum_over_ranks`` and ``mean_over_ranks``: the same without a gradient
  (the centroid EMA's sums, the logged diagnostics);
- ``global_rows``: noise drawn for the global batch from the generator
  every rank seeds alike, this rank's rows kept;
- ``world_size``: the count of ranks whose rows make the batch.

They act only inside ``global_batch(info)``, which the trainer enters for
its step when a process group exists.  Outside it they reduce nothing and
draw for the local batch, which is the one-process trainer's arithmetic;
and inside it at one rank every collective is an identity, so a run of
one rank computes what the one-process trainer computes, bit for bit.

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: gloo runs
all three on CUDA tensors, so two ranks can share one GPU over gloo when
the caller names that backend.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Optional, Sequence

import torch
import torch.distributed as dist

from playablevideogeneration_tpu_torch.utils.device import DeviceLike, resolve_device

# The environment torchrun gives each process it starts.
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@dataclass(frozen=True)
class ProcessInfo:
    """This process's place in the group: a rank is a JAX device, a node
    (one torchrun launch, ``local_world`` ranks) a JAX process."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1

    @property
    def node(self) -> int:
        return self.rank // self.local_world

    @property
    def nodes(self) -> int:
        return self.world // self.local_world


def process_info() -> ProcessInfo:
    """Rank, world, local rank and local world of the process group (the
    last two from torchrun's environment), or a world of one without a
    group."""
    if not dist.is_initialized():
        return ProcessInfo()
    rank, world = dist.get_rank(), dist.get_world_size()
    info = ProcessInfo(rank, world, int(os.environ.get("LOCAL_RANK", rank)),
                       int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if world % info.local_world or info.local_rank >= info.local_world:
        raise RuntimeError(f"inconsistent process layout: {info}")
    return info


def init_distributed(device: DeviceLike = "cuda", backend: Optional[str] = None,
                     init_method: str = "env://") -> torch.device:
    """Joins the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, and
    ``MASTER_ADDR`` and ``MASTER_PORT`` for the default ``env://``) and
    returns this rank's device, made current: ``cuda:LOCAL_RANK`` for
    ``"cuda"``, or the GPU that ``device`` names by index (ranks that share
    a GPU, over gloo).  The backend is NCCL for CUDA and gloo for the CPU
    unless ``backend`` names one.  Without that environment it forms no
    group and returns ``device``.

    Raises when the environment is partial, when this rank's GPU is not
    visible, and when the group cannot form (NCCL's communicator is
    created here, not at the first collective).
    """
    present = [k for k in TORCHRUN_ENV if k in os.environ]
    device = resolve_device(device)
    if not present:
        return device
    if len(present) != len(TORCHRUN_ENV):
        raise RuntimeError(f"partial torchrun environment: {present} set, "
                           f"{sorted(set(TORCHRUN_ENV) - set(present))} missing")
    rank, world, local_rank, local_world = (int(os.environ[k]) for k in TORCHRUN_ENV)
    if device.type == "cuda":
        index = local_rank if device.index is None else device.index
        visible = torch.cuda.device_count()
        if index >= visible:
            raise RuntimeError(f"LOCAL_RANK {local_rank} needs GPU {index}, but only "
                               f"{visible} are visible")
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            **kwargs)
    process_info()  # checks the layout
    barrier()
    return device


def barrier() -> None:
    """Waits for every rank (NCCL's barrier on this rank's GPU)."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


# The ranks whose rows make the batch of the step running now, set by
# ``global_batch``; None outside a data-parallel step.
_GLOBAL_BATCH: Optional[ProcessInfo] = None


@contextlib.contextmanager
def global_batch(info: ProcessInfo) -> Iterator[None]:
    """Within the block (a training step's forward and backward), the batch
    is the global one that ``info``'s ranks hold between them."""
    global _GLOBAL_BATCH
    previous, _GLOBAL_BATCH = _GLOBAL_BATCH, info
    try:
        yield
    finally:
        _GLOBAL_BATCH = previous


def world_size() -> int:
    """The count of ranks whose rows make the batch: 1 outside
    ``global_batch``."""
    return 1 if _GLOBAL_BATCH is None else _GLOBAL_BATCH.world


class AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, forward and backward: each rank's loss depends
    on every rank's input, so each input's gradient is the sum of every
    rank's cotangent."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably (``AllReduceSum``).
    Outside ``global_batch`` a copy: one node in the autograd graph where
    ``AllReduceSum`` is one, so that a step of one rank in a group and a
    step with no group run their backward in the same order, and the
    one-process step pays no Python call for it."""
    if _GLOBAL_BATCH is None:
        return x.clone()
    return AllReduceSum.apply(x)


@torch.no_grad()
def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, without a gradient; ``x`` itself
    outside ``global_batch``."""
    if _GLOBAL_BATCH is None:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y)
    return y


@torch.no_grad()
def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the ranks, without a gradient: a per-rank mean
    of equal-sized batches becomes the global batch's mean."""
    if _GLOBAL_BATCH is None:
        return x
    return sum_over_ranks(x) / _GLOBAL_BATCH.world


def global_rows(draw: Callable[[Sequence[int]], torch.Tensor],
                shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` for this rank's rows of the global batch: ``draw``
    of the global shape (dim 0 times the world), rows ``rank * shape[0]``
    on.  Every rank's generator is seeded alike and draws the whole
    array, so the ranks' rows in rank order are the one-process draw and
    the generators stay in step."""
    if _GLOBAL_BATCH is None:
        return draw(tuple(shape))
    rows, rank = shape[0], _GLOBAL_BATCH.rank
    full = draw((rows * _GLOBAL_BATCH.world,) + tuple(shape[1:]))
    return full[rank * rows:(rank + 1) * rows]


def _flat_groups(tensors: Iterable[torch.Tensor]):
    """The tensors grouped by dtype and device, in order."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups.values()


@torch.no_grad()
def broadcast_from_rank0(module: torch.nn.Module) -> None:
    """Copies rank 0's parameters and buffers into every rank's module: one
    broadcast per dtype."""
    for tensors in _flat_groups(list(module.parameters()) + list(module.buffers())):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, src=0)
        for t, value in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(value.view_as(t))


@torch.no_grad()
def all_reduce_gradients(parameters: Iterable[torch.nn.Parameter], world: int) -> None:
    """Replaces every parameter's gradient by its mean over the ranks: one
    flat buffer per dtype, one ``all_reduce``, then a division by
    ``world``.  Every parameter must have a gradient."""
    for grads in _flat_groups([p.grad for p in parameters]):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= world
        for g, value in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(value.view_as(g))
