"""Joining the world, and the pod input pipeline (port of
``jarvis_hybridnet_tpu/parallel/multihost.py``).

One process per GPU, launched by ``torchrun`` (which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``):

- :func:`initialize_distributed` joins the process group: NCCL by default,
  gloo only where the caller names it (the CPU tests, two ranks sharing one
  card). With ``WORLD_SIZE`` unset or 1 and no explicit request it does
  nothing and everything runs on one process as before. Where the world has
  more than one process and the group cannot be joined, it raises: it never
  drops to one process or to another backend (the JAX package's rule,
  ``multihost.py:28-60``).
- Every rank of a data group agrees on the global sample order of an epoch
  and takes its ``process_batch_slice`` of each global batch
  (:class:`MultiHostLoader`, on the port's thread ``DataLoader``); the
  camera ranks of one data group load the same samples.
- :func:`process_frame_range` is a recording's contiguous frame range of a
  data group, for the prediction drivers' pod streaming.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..dataset import loader
from ..dataset.loader import _collate
from ..utils import clp


def world_size() -> int:
    """The processes of the world: the joined group's, else ``WORLD_SIZE``."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_rank() -> int:
    """This process's GPU on its host (``LOCAL_RANK``, 0 without it)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_distributed(backend: str | None = None, init_method: str | None = None,
                           world_size: int | None = None, rank: int | None = None,
                           timeout: datetime.timedelta | None = None) -> bool:
    """Join the world's process group (idempotent). Returns True when a
    group is joined (or was), False for one process with nothing asked.

    ``backend`` defaults to NCCL; ``init_method`` to torchrun's ``env://``;
    ``world_size`` and ``rank`` to ``WORLD_SIZE`` and ``RANK``. Under NCCL
    the process takes ``cuda:LOCAL_RANK`` as its current device first. A
    group asked for explicitly (any argument given) or implied by
    ``WORLD_SIZE`` > 1 that cannot be joined raises.
    """
    if dist.is_initialized():
        return True
    explicit = any(a is not None for a in (backend, init_method, world_size, rank))
    n = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else int(world_size)
    if n <= 1 and not explicit:
        return False
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(f"WORLD_SIZE {n}: NCCL needs CUDA, and none is available; "
                               "name the backend to run elsewhere")
        torch.cuda.set_device(local_rank())
    kwargs = {"backend": backend, "init_method": init_method or "env://", "world_size": n,
              "rank": int(os.environ.get("RANK", "0")) if rank is None else int(rank)}
    if timeout is not None:
        kwargs["timeout"] = timeout
    dist.init_process_group(**kwargs)
    return True


def process_batch_slice(global_batch_size: int, process_index: int | None = None,
                        process_count: int | None = None) -> tuple[int, int]:
    """[lo, hi) slice of each global batch owned by this data group (the
    data axis of the mesh is laid out group-major, so a contiguous slice of
    the batch is exactly the set of rows of this group)."""
    pi = _rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    if global_batch_size % pc != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{pc} processes"
        )
    per = global_batch_size // pc
    return pi * per, (pi + 1) * per


def process_frame_range(n_frames: int, process_index: int | None = None,
                        process_count: int | None = None) -> tuple[int, int]:
    """Contiguous [start, stop) frame range of a recording owned by this
    data group: each group decodes only its own time slice of the videos."""
    pi = _rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    per = n_frames // pc
    extra = n_frames % pc
    start = pi * per + min(pi, extra)
    return start, start + per + (1 if pi < extra else 0)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class _IndexView:
    """Zero-copy view of a dataset restricted to an index list."""

    def __init__(self, dataset, indices):
        self._dataset = dataset
        self._indices = indices

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, i):
        return self._dataset[int(self._indices[i])]

    def __getattr__(self, name):
        return getattr(self._dataset, name)


class MultiHostLoader:
    """Pod-wide data loader: each data group builds its slice of every
    global batch.

    Every rank constructs the identical seeded shuffle of the dataset,
    takes its ``process_batch_slice`` of each global batch and builds those
    samples on its thread pool (``dataset.loader.DataLoader``), yielding
    the host batches of its slice. ``drop_last`` is forced: a step needs
    every data group to contribute an identically-shaped slice.
    ``process_index`` / ``process_count`` are the data index and the data
    axis of the mesh (the camera ranks of one data group load the same
    slice).
    """

    def __init__(self, dataset, global_batch_size: int, shuffle: bool = False, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 2, process_index: int | None = None,
                 process_count: int | None = None, worker_mode: str = "thread"):
        self.dataset = dataset
        self.global_batch_size = int(global_batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.worker_mode = worker_mode
        self._pi = _rank() if process_index is None else process_index
        self._pc = world_size() if process_count is None else process_count
        self._lo, self._hi = process_batch_slice(self.global_batch_size, self._pi, self._pc)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the ABSOLUTE epoch of the next ``__iter__`` (the contract of
        ``dataset.loader.DataLoader.set_epoch``)."""
        self._epoch = int(epoch)

    def __len__(self):
        return len(self.dataset) // self.global_batch_size

    def _epoch_order(self, epoch: int) -> np.ndarray:
        # identical order on every process: the seed depends only on (seed,
        # epoch), never on the process index
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        return order

    def _local_indices(self, order: np.ndarray) -> np.ndarray:
        """This data group's sample indices, in global batch order."""
        n_batches = len(order) // self.global_batch_size
        if not n_batches:
            return np.empty((0,), np.int64)
        return np.concatenate([
            order[b * self.global_batch_size + self._lo:
                  b * self.global_batch_size + self._hi]
            for b in range(n_batches)
        ])

    def __iter__(self):
        epoch = self._epoch
        order = self._epoch_order(epoch)
        self._epoch += 1
        local = loader.DataLoader(
            _IndexView(self.dataset, self._local_indices(order)),
            batch_size=self._hi - self._lo,
            shuffle=False,
            drop_last=True,
            prefetch=self.prefetch,
            seed=self.seed + 7919 * (self._pi + 1),
            num_workers=self.num_workers,
            worker_mode=self.worker_mode,
        )
        local.set_epoch(epoch)
        yield from local


def make_dp_loaders(train_set, val_set, batch_size: int, num_workers: int, mesh,
                    drop_last: bool = False, seed: int = 0, worker_mode: str = "thread"):
    """(train_loader, val_loader) for the data-parallel plan.

    With a mesh of more than one data group: ``MultiHostLoader``s over its
    data axis, each yielding this group's slice of a global batch of
    ``batch_size``. Otherwise plain host ``DataLoader``s of ``batch_size``
    (``drop_last`` forced under a mesh: every rank must receive a full
    batch)."""
    if mesh is not None and mesh.n_data > 1:
        def mk(ds, shuffle):
            return MultiHostLoader(ds, batch_size, shuffle=shuffle, seed=seed,
                                   num_workers=num_workers, process_index=mesh.data_index,
                                   process_count=mesh.n_data, worker_mode=worker_mode)
        return mk(train_set, True), mk(val_set, False)
    drop = drop_last or mesh is not None
    if mesh is not None and len(val_set) < batch_size:
        clp.warning(
            f"Validation set ({len(val_set)} samples) is smaller than the "
            f"batch size ({batch_size}) and tail batches are dropped under "
            f"a device mesh: the epoch will see ZERO validation batches "
            f"and val metrics will be empty. Shrink BATCH_SIZE or grow the "
            f"val split.")
    return (
        loader.DataLoader(train_set, batch_size=batch_size, shuffle=True, drop_last=drop,
                   num_workers=num_workers, seed=seed, worker_mode=worker_mode),
        loader.DataLoader(val_set, batch_size=batch_size, shuffle=False, drop_last=drop,
                   num_workers=num_workers, worker_mode=worker_mode),
    )


def local_np(x) -> np.ndarray:
    """This rank's rows of ``x`` as numpy (a tensor on any device, or an
    array): each rank holds only its own rows."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


__all__ = [
    "MultiHostLoader",
    "initialize_distributed",
    "local_np",
    "local_rank",
    "make_dp_loaders",
    "process_batch_slice",
    "process_frame_range",
    "world_size",
    "_collate",
]
