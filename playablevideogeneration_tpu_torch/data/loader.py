"""Host input pipeline: shuffling, batching and prefetching.

Counterpart of ``playablevideogeneration_tpu/data/loader.py``, with the
same numpy shuffle, so one seed gives the same batches in both packages.
Workers read, transform and collate batches ahead of the training loop:

- ``worker_mode="thread"``: threads in the process; image decoding holds
  the interpreter lock, so they use about one core;
- ``worker_mode="process"``: a pool of forked processes, which decodes on
  as many cores as it has workers.  Its batches carry no ``Video``
  back-references (arrays only).  The parent may hold a CUDA context: the
  workers run only this module's numpy and Pillow code and never touch
  ``torch.cuda``, which a forked child of an initialised CUDA process must
  not do.

Sharding: every process shuffles with the same seed and takes the strided
slice ``shard_index::shard_count`` of the epoch, as a JAX process does.  A
data-parallel node is such a process, and each of its ``local_world``
ranks then takes the contiguous rows ``[l * b / L, (l + 1) * b / L)`` of
every batch of ``b`` (``l`` its local rank), as a JAX process's devices
take their slices of its batch: the ranks' rows in rank order are the
node's batch.
"""
from __future__ import annotations

import itertools
import queue
import threading
from collections import deque
from typing import Iterator, Optional

import numpy as np

from playablevideogeneration_tpu_torch.data.video_dataset import Batch, VideoDataset, collate
from playablevideogeneration_tpu_torch.utils import tracing

# How long a process-mode batch may take before its worker counts as dead.
WORKER_TIMEOUT_S = 300.0
# The consumer's taking of one batch, its wait for the workers included.
_GET = tracing.span("loader.get")
# The dataset of a forked pool worker; set in the worker only, by the
# pool's initializer (the fork hands the dataset over without pickling it).
_WORKER_DATASET: Optional[VideoDataset] = None


def _init_worker(dataset: VideoDataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _collate_arrays(indices) -> Batch:
    batch = collate([_WORKER_DATASET[int(j)] for j in indices])
    return Batch(observations=batch.observations, actions=batch.actions,
                 rewards=batch.rewards, dones=batch.dones, videos=[],
                 initial_frames=batch.initial_frames)


class DataLoader:
    """Iterates shuffled, collated batches with background prefetch; an
    incomplete last batch is dropped when ``drop_last``.  With
    ``local_world`` above 1 each batch holds this rank's ``batch_size /
    local_world`` rows of it.  Taking each batch, the wait for the workers
    included, is the span ``loader.get`` (``utils.tracing``)."""

    def __init__(self, dataset: VideoDataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 2, prefetch: int = 2,
                 seed: int = 0, worker_mode: str = "thread", shard_index: int = 0,
                 shard_count: int = 1, local_rank: int = 0, local_world: int = 1):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"Unknown worker_mode '{worker_mode}'")
        if batch_size % local_world or not (drop_last or local_world == 1):
            raise ValueError(f"a batch of {batch_size} does not split into equal rows for "
                             f"{local_world} ranks (drop_last={drop_last})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.worker_mode = worker_mode
        self.shard_index = shard_index
        self.shard_count = max(1, shard_count)
        rows = batch_size // local_world
        self.rows = slice(local_rank * rows, (local_rank + 1) * rows)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = (len(self.dataset) - len(self.dataset) % self.shard_count) // self.shard_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self):
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(indices)
        if self.shard_count > 1:
            # Every shard gets the same count: truncate to a multiple first.
            limit = len(indices) - (len(indices) % self.shard_count)
            indices = indices[:limit][self.shard_index::self.shard_count]
        limit = ((len(indices) // self.batch_size) * self.batch_size if self.drop_last
                 else len(indices))
        for start in range(0, limit, self.batch_size):
            yield indices[start:start + self.batch_size][self.rows]

    def _iter_process(self, batches) -> Iterator[Batch]:
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        it = iter(batches)
        with ctx.Pool(self.num_workers, initializer=_init_worker,
                      initargs=(self.dataset,)) as pool:
            pending = deque(pool.apply_async(_collate_arrays, (idxs.tolist(),))
                            for idxs in itertools.islice(it, self.prefetch + self.num_workers))
            while pending:
                # Bounded: a worker killed mid-batch is replaced by the pool,
                # but its batch never arrives.
                try:
                    with _GET:
                        batch = pending.popleft().get(timeout=WORKER_TIMEOUT_S)
                except mp.TimeoutError:
                    raise RuntimeError(
                        f"process-mode loader worker produced no batch within "
                        f"{WORKER_TIMEOUT_S}s; a forked worker likely died; try "
                        f"worker_mode='thread'") from None
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.apply_async(_collate_arrays, (nxt.tolist(),)))
                yield batch

    def __iter__(self) -> Iterator[Batch]:
        batches = list(self._batch_indices())
        if not batches:
            return
        if self.worker_mode == "process":
            yield from self._iter_process(batches)
            return
        task_q: "queue.Queue" = queue.Queue()
        for i, idxs in enumerate(batches):
            task_q.put((i, idxs))
        results = {}
        cond = threading.Condition()
        stop = threading.Event()
        max_ahead = self.prefetch + self.num_workers
        next_needed = [0]

        def worker():
            while not stop.is_set():
                try:
                    i, idxs = task_q.get_nowait()
                except queue.Empty:
                    return
                # At most max_ahead batches ahead of the consumer.
                with cond:
                    while not stop.is_set() and i - next_needed[0] >= max_ahead:
                        cond.wait(timeout=1.0)
                if stop.is_set():
                    return
                try:
                    batch = collate([self.dataset[int(j)] for j in idxs])
                except Exception as e:  # handed to the consumer, which raises it
                    batch = e
                with cond:
                    results[i] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                with _GET, cond:
                    next_needed[0] = i
                    cond.notify_all()
                    while i not in results:
                        cond.wait(timeout=5.0)
                        if i not in results and not any(t.is_alive() for t in threads):
                            raise RuntimeError("Data loader workers died")
                    value = results.pop(i)
                if isinstance(value, Exception):
                    raise value
                yield value
        finally:
            stop.set()
            with cond:
                cond.notify_all()
