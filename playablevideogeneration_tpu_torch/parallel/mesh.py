"""Data and tensor parallelism over several GPUs with ``torch.distributed``.

Counterpart of ``playablevideogeneration_tpu/parallel/mesh.py`` and of
``utils/jax_setup.py``'s ``setup_multihost`` and ``process_info``.  A rank
is a JAX device, a node (one torchrun launch) a JAX process, and the
ranks form the JAX package's ``(data, model)`` grid: rank ``r`` sits at
data index ``r // M`` and model index ``r % M`` (``make_mesh``), the
reshape of the device list that ``make_mesh`` there does.  The ``M``
ranks of one data index form a *model group* and hold the same rows of
the batch; the ranks of one model index form a *data group*.

The JAX train step is written over the *global* batch and GSPMD shards
it, so every reduction over the batch spans the data axis and the noise is
drawn for the global array.  Here each rank runs the step on its data
index's rows of the global batch, and the code that reduces over the
batch asks this module, which reduces over the data group only (a model
group's ranks hold the same rows, and summing over them would count each
row ``M`` times):

- ``all_reduce_sum``: a differentiable sum (train-mode BatchNorm's sums of
  x and x^2, the mutual-information joint matrix);
- ``sum_over_ranks`` and ``mean_over_ranks``: the same without a gradient
  (the centroid EMA's sums, the logged diagnostics);
- ``global_rows``: noise drawn for the global batch from the generator
  every rank seeds alike, this data index's rows kept;
- ``world_size``: the count of data indices whose rows make the batch.

They act only inside ``global_batch(mesh)``, which the trainer enters for
its step when a process group exists.  Outside it, and inside it with a
data group of one rank, they reduce nothing and draw for the local batch,
which is the one-process trainer's arithmetic with the same graph nodes:
a run of one rank computes what the one-process trainer computes, bit for
bit.

Tensor parallelism (``tpu.model_parallel`` above 1) splits the output
channels of wide kernels over the model group (``models.layers
.ColumnParallel``), with Megatron's column-parallel pair of autograd
functions: ``copy_to_model`` (the identity forward, a sum over the model
group backward) and ``gather_from_model`` (the slices gathered forward,
this rank's slice kept backward).  ``gather_rows`` gathers a sharded
tensor without a gradient, for checkpoints and evaluation.

Only ``all_reduce``, ``all_gather``, ``broadcast`` and ``barrier`` are
used: gloo runs them on CUDA tensors, so ranks can share one GPU over gloo
when the caller names that backend.
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


@dataclass(frozen=True)
class MeshInfo:
    """This rank's place in the ``(data, model)`` grid of ranks, and the
    groups it reduces and gathers over.  A group of ``None`` is the default
    group of every rank: the data group when ``model_size`` is 1, the model
    group when ``data_size`` is 1 (a group that is the whole world is not
    made twice)."""

    process: ProcessInfo = ProcessInfo()
    model_size: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def data_index(self) -> int:
        return self.process.rank // self.model_size

    @property
    def data_size(self) -> int:
        return self.process.world // self.model_size

    @property
    def model_index(self) -> int:
        return self.process.rank % self.model_size


def make_mesh(process: ProcessInfo, model_parallel: int = 1) -> MeshInfo:
    """The ``(world / M) x M`` grid of ``process``'s world, with ``M`` the
    model-axis size.  Raises when ``M`` does not divide the world (the JAX
    ``make_mesh``'s "does not cover") or the ranks of a node (a JAX process
    owns whole rows of the grid).

    When both axes are longer than one rank, every rank creates every group
    in the same order, as ``torch.distributed.new_group`` requires: the
    model groups (``M`` consecutive ranks) by data index, then the data
    groups (ranks ``m, m + M, ...``) by model index."""
    m, world = model_parallel, process.world
    if m < 1 or world % m:
        raise ValueError(f"a mesh of model size {m} (tpu.model_parallel) does not cover "
                         f"{world} rank(s)")
    if process.local_world % m:
        raise ValueError(f"tpu.model_parallel {m} does not divide the {process.local_world} "
                         f"rank(s) of a node: a node holds whole rows of the mesh")
    info = MeshInfo(process, m)
    if m > 1 and world > m:
        model_groups = [dist.new_group(list(range(d * m, (d + 1) * m)))
                        for d in range(world // m)]
        data_groups = [dist.new_group(list(range(i, world, m))) for i in range(m)]
        info = MeshInfo(process, m, data_groups[info.model_index],
                        model_groups[info.data_index])
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


# The mesh whose data indices' rows make the batch of the step running
# now, set by ``global_batch``; None outside a data-parallel step.
_GLOBAL_BATCH: Optional[MeshInfo] = None


@contextlib.contextmanager
def global_batch(info: MeshInfo) -> Iterator[None]:
    """Within the block (a training step's forward and backward), the batch
    is the global one that ``info``'s data indices hold between them."""
    global _GLOBAL_BATCH
    previous, _GLOBAL_BATCH = _GLOBAL_BATCH, info
    try:
        yield
    finally:
        _GLOBAL_BATCH = previous


def _data_group() -> Optional[MeshInfo]:
    """The mesh of the step running now when its data axis holds more than
    one rank, else None (every batch reduction is then local)."""
    if _GLOBAL_BATCH is None or _GLOBAL_BATCH.data_size == 1:
        return None
    return _GLOBAL_BATCH


def world_size() -> int:
    """The count of data indices whose rows make the batch: 1 outside
    ``global_batch``."""
    return 1 if _GLOBAL_BATCH is None else _GLOBAL_BATCH.data_size


class AllReduceSum(torch.autograd.Function):
    """Sum over a group, forward and backward: each rank's loss depends on
    every rank's input, so each input's gradient is the sum of every
    rank's cotangent."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group, differentiably (``AllReduceSum``).
    Outside ``global_batch``, or with a data group of one rank, a copy: one
    node in the autograd graph where ``AllReduceSum`` is one, so that both
    run their backward in the same order, and the one-process step pays no
    Python call for it."""
    info = _data_group()
    if info is None:
        return x.clone()
    return AllReduceSum.apply(x, info.data_group)


@torch.no_grad()
def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group, without a gradient; ``x`` itself
    outside ``global_batch`` or with a data group of one rank."""
    info = _data_group()
    if info is None:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=info.data_group)
    return y


@torch.no_grad()
def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the data group, without a gradient: a per-rank
    mean of equal-sized batches becomes the global batch's mean."""
    info = _data_group()
    if info is None:
        return x
    return sum_over_ranks(x) / info.data_size


def global_rows(draw: Callable[[Sequence[int]], torch.Tensor],
                shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` for this data index's rows of the global batch:
    ``draw`` of the global shape (dim 0 times the data size), rows
    ``data_index * shape[0]`` on.  Every rank's generator is seeded alike
    and draws the whole array, so the rows in data-index order are the
    one-process draw, a model group's ranks draw the same rows, and the
    generators stay in step."""
    info = _data_group()
    if info is None:
        return draw(tuple(shape))
    rows, index = shape[0], info.data_index
    full = draw((rows * info.data_size,) + tuple(shape[1:]))
    return full[index * rows:(index + 1) * rows]


class CopyToModel(torch.autograd.Function):
    """The identity forward; the cotangent summed over the model group
    backward, since each rank's output slice gives a partial gradient of
    the input that every rank of the group holds."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class GatherFromModel(torch.autograd.Function):
    """The model group's slices concatenated along ``dim`` in model-index
    order forward; this rank's slice of the cotangent backward, since what
    follows is computed alike on every rank of the group, so every rank
    holds the same full cotangent."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, info: MeshInfo) -> torch.Tensor:
        ctx.dim, ctx.index, ctx.rows = dim, info.model_index, x.shape[dim]
        return _all_gather(x, dim, info)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.narrow(ctx.dim, ctx.index * ctx.rows, ctx.rows), None, None


def _all_gather(x: torch.Tensor, dim: int, info: MeshInfo) -> torch.Tensor:
    """The model group's ``x`` concatenated along ``dim``; images (N, C, H,
    W) along their channels as (N, H, W, C), so that the result is stored
    channels-last, as the model keeps its activations."""
    if x.dim() == 4 and dim == 1:
        return _all_gather(x.movedim(1, -1), -1, info).movedim(-1, 1)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(info.model_size)]
    dist.all_gather(parts, x, group=info.model_group)
    return torch.cat(parts, dim=dim)


def copy_to_model(x: torch.Tensor, info: MeshInfo) -> torch.Tensor:
    """``x`` entering a column-parallel layer of the model group
    (``CopyToModel``)."""
    return CopyToModel.apply(x, info.model_group)


def gather_from_model(x: torch.Tensor, dim: int, info: MeshInfo) -> torch.Tensor:
    """A column-parallel layer's output slices, gathered along ``dim``
    (``GatherFromModel``)."""
    return GatherFromModel.apply(x, dim, info)


@torch.no_grad()
def gather_rows(x: torch.Tensor, info: MeshInfo) -> torch.Tensor:
    """The model group's slices of a sharded tensor (its rows, dim 0)
    concatenated in model-index order, without a gradient: the full tensor
    on every rank of the group."""
    return _all_gather(x.detach(), 0, info)


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
def all_reduce_gradients(parameters: Iterable[torch.nn.Parameter], info: MeshInfo) -> None:
    """Replaces every parameter's gradient by its mean over the data group:
    one flat buffer per dtype, one ``all_reduce``, then a division by the
    data size; nothing with a data group of one rank.  A replicated
    parameter's gradient already agrees across its model group, and a
    sharded slice's is averaged with the ranks that hold the same slice.
    Every parameter must have a gradient."""
    if info.data_size == 1:
        return
    for grads in _flat_groups([p.grad for p in parameters]):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=info.data_group)
        flat /= info.data_size
        for g, value in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(value.view_as(g))
