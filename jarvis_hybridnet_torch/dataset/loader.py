"""Batching data loader with thread workers and prefetch (the single-device
part of ``jarvis_hybridnet_tpu/dataset/loader.py``).

Samples of a batch are built concurrently on a thread pool: JPEG decode via
cv2 / libjpeg and the native C++ pipeline release the GIL, so threads
parallelize the heavy work. Batches are emitted in submission order, and a
bounded prefetch queue lets host data building overlap device compute. The
pod loaders of several processes are ``parallel/multihost`` (each rank's
slice of every global batch, on this loader). The JAX package's
forked-process worker modes wait for ROADMAP.md A.12a; ``worker_mode``
other than ``'thread'`` raises, and the trainers pass what
:func:`trainer_worker_mode` gives for their config.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

class _ProducerError:
    """Sentinel carrying a producer-side exception to the consumer.

    Without it, a sample-building failure kills the producer thread
    silently and the consuming loop blocks on the queue forever.
    """

    def __init__(self, exc: BaseException):
        self.exc = exc


def available_ram_bytes() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:  # pragma: no cover
        pass
    try:  # pragma: no cover - non-Linux fallback (no /proc/meminfo)
        return (os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))
    except (ValueError, OSError, AttributeError):  # pragma: no cover
        return 4 << 30


def maybe_preload(cfg, *datasets) -> None:
    """Honor ``DATALOADER_PRELOAD`` for datasets that support an in-memory
    decoded-sample cache: 'auto' (default) preloads when the cache fits in
    half the available RAM, 'on' forces, 'off' disables."""
    mode = str(cfg.get("DATALOADER_PRELOAD", "auto")).lower()
    if mode in ("off", "false", "0", "none"):
        return
    targets = [d for d in datasets if hasattr(d, "preload")]
    need = sum(d.preload_nbytes() for d in targets)
    if mode == "auto" and need > 0.5 * available_ram_bytes():
        from ..utils import clp

        clp.info(f"Dataset preload skipped ({need / 1e9:.1f} GB cache vs "
                 f"{available_ram_bytes() / 1e9:.1f} GB available); set "
                 "DATALOADER_PRELOAD: on to force")
        return
    for d in targets:
        d.preload()


def _collate(samples):
    first = samples[0]
    if isinstance(first, dict):
        return {
            k: _collate([s[k] for s in samples])
            for k in first
        }
    if isinstance(first, (list, tuple)):
        return type(first)(
            _collate([s[i] for s in samples]) for i in range(len(first))
        )
    if isinstance(first, str):
        return list(samples)
    return np.stack([np.asarray(s) for s in samples])


def trainer_worker_mode(cfg) -> str:
    """The worker mode a trainer passes to its loaders: ``'thread'``. A
    config whose ``DATALOADER_WORKER_MODE`` asks for process workers (the
    default, ``'process'``) is told once, by a warning, that thread workers
    stand in for them."""
    mode = str(cfg.get("DATALOADER_WORKER_MODE", "process"))
    if mode != "thread":
        from ..utils import clp

        clp.warning(f"DATALOADER_WORKER_MODE {mode!r}: the port's loader runs thread workers "
                    "in its place until process workers are ported (ROADMAP.md A.12a)")
    return "thread"


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        prefetch: int = 2,
        seed: int = 0,
        num_workers: int = 4,
        worker_mode: str = "thread",
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.seed = seed
        self._epoch = 0
        self.num_workers = max(0, int(num_workers))
        if worker_mode != "thread":
            raise ValueError(f"worker_mode {worker_mode!r}: only 'thread' workers are "
                             "ported (process workers wait for ROADMAP.md A.12a)")
        self.worker_mode = worker_mode

    def set_epoch(self, epoch: int) -> None:
        """Pin the ABSOLUTE epoch the next ``__iter__`` belongs to.

        Shuffle order derives from ``(seed, epoch)``, not from a stateful
        RNG: a run resumed at epoch k (``--resume latest`` after preemption)
        must see epoch k's permutation, not replay epoch 0's.
        Trainers call this at every epoch top; plain iteration without it
        still advances one epoch per ``__iter__``.
        """
        self._epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        epoch_rng = np.random.default_rng((self.seed, self._epoch))
        self._epoch += 1
        order = np.arange(len(self.dataset))
        if self.shuffle:
            epoch_rng.shuffle(order)
        batches = [
            order[i: i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_checked(item) -> bool:
            """Bounded put that gives up once the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    pass
            return False

        if self.num_workers == 0:
            def produce_serial():
                try:
                    for idxs in batches:
                        if stop.is_set():
                            break
                        if not put_checked(
                            _collate([self.dataset[int(i)] for i in idxs])
                        ):
                            return
                    put_checked(None)
                except BaseException as e:  # propagate to the consumer
                    put_checked(_ProducerError(e))

            thread = threading.Thread(target=produce_serial, daemon=True)
        else:
            pool = ThreadPoolExecutor(max_workers=self.num_workers)

            def produce():
                it = iter(batches)
                pending: deque = deque()

                def submit_next() -> bool:
                    idxs = next(it, None)
                    if idxs is None:
                        return False
                    pending.append([
                        pool.submit(self.dataset.__getitem__, int(i))
                        for i in idxs
                    ])
                    return True

                put = put_checked

                try:
                    # keep prefetch+1 batches worth of samples in flight
                    for _ in range(self.prefetch + 1):
                        if not submit_next():
                            break
                    while pending:
                        futs = pending.popleft()
                        batch = _collate([f.result() for f in futs])
                        submit_next()
                        if not put(batch):
                            return
                    put(None)
                except BaseException as e:  # propagate to the consumer
                    put(_ProducerError(e))
                finally:
                    pool.shutdown(wait=False, cancel_futures=True)

            thread = threading.Thread(target=produce, daemon=True)

        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, _ProducerError):
                    raise item.exc
                yield item
        finally:
            stop.set()
