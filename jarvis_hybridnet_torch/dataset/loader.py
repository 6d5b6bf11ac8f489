"""Batching data loader with multi-worker sample building and prefetch (a
copy of ``jarvis_hybridnet_tpu/dataset/loader.py`` for the port).

Four worker modes, as the JAX package's:

* ``worker_mode='thread'``: samples of a batch are built concurrently on a
  thread pool. JPEG decode via cv2 / libjpeg and the native C++ pipeline
  release the GIL, so threads parallelize the heavy work, but GIL-holding
  work (numpy augmentation, 3D target synthesis) serializes.
* ``worker_mode='process'`` (the config's default): forked worker processes
  each build and collate whole batches and ship them back through pickled
  numpy buffers. Fork means the dataset and its index (and the
  ``maybe_preload`` cache) are inherited copy-on-write with no per-worker
  set-up. The workers run numpy and cv2 only: never ``torch.cuda`` (a
  forked child that touches it raises, which is wanted) and no torch op
  (a torch CPU op in a forked child can hang on the inherited intra-op
  pool), so :func:`_collate` is numpy.
* ``worker_mode='forkserver' | 'spawn'``: the same batch-building protocol
  through a clean-child multiprocessing context, for datasets that run
  arbitrary code in ``__getitem__``: the dataset is pickled to every
  worker each epoch (no copy-on-write inheritance).

In the process modes every epoch starts a fresh ``multiprocessing.Pool``
(forked from the calling thread in 'process' mode) whose workers reseed
their generators from ``SeedSequence([epoch_seed, pid])``, ``epoch_seed``
drawn from the epoch's ``(seed, epoch)`` generator
(:func:`_reseed_forked_rngs`). A batch that takes longer than
``JARVIS_WORKER_DEADLINE_S`` seconds (default 300, read at every epoch; 0
waits forever) raises ``RuntimeError``: a killed worker's task is lost by
the pool. A worker's exception reaches the consumer. At an epoch's end the
pool is terminated, joined for at most 10 s, and its workers killed with
SIGKILL where they outlive that.

Batches are emitted in submission order in every mode, and a bounded
prefetch queue lets host data building overlap device compute. The pod
loaders of several processes are ``parallel/multihost`` (each rank's slice
of every global batch, on this loader).
"""

from __future__ import annotations

import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_FORK_POOL_DATASET = None


def worker_deadline_s() -> float:
    """Seconds to wait for one batch from a worker pool before declaring a
    worker dead: ``JARVIS_WORKER_DEADLINE_S`` (default 300; 0 disables the
    deadline)."""
    return float(os.environ.get("JARVIS_WORKER_DEADLINE_S", 300.0))


def _rng_holders(dataset) -> list:
    """The objects whose generators a worker reseeds: the dataset and its
    ``augpipe``, then those of the dataset a view wraps (``_dataset``, as
    ``parallel/multihost``'s per-rank view holds it)."""
    holders, obj = [], dataset
    while obj is not None and hasattr(obj, "__dict__"):
        holders += [o for o in (obj, vars(obj).get("augpipe")) if o is not None]
        obj = vars(obj).get("_dataset")
    return holders


def _reseed_forked_rngs(dataset, epoch_seed: int) -> None:
    """Give this worker its own RNG streams.

    Forked children inherit byte-identical copies of the parent's
    ``np.random.Generator`` state, so without this every worker, and every
    epoch's freshly forked pool, would draw the same augmentation sequence.
    A distinct stream per (epoch, worker, generator attribute) is derived
    from the parent-drawn epoch seed and this child's pid, as the JAX
    package derives it.
    """
    from ..utils.rng import ThreadLocalGenerator

    targets = [
        (obj, name, val)
        for obj in _rng_holders(dataset)
        for name, val in vars(obj).items()
        if isinstance(val, (np.random.Generator, ThreadLocalGenerator))
    ]
    seq = np.random.SeedSequence([int(epoch_seed), os.getpid()])
    for (obj, name, val), child in zip(targets, seq.spawn(len(targets))):
        if isinstance(val, ThreadLocalGenerator):
            val.reseed(child)
        else:
            setattr(obj, name, np.random.default_rng(child))


def _fork_worker_init(dataset, epoch_seed):
    """Runs once in each worker: signal dispositions, the dataset, its
    generators' streams, cv2's threads."""
    import signal

    # Workers inherit the parent's signal dispositions, PreemptionGuard's
    # SIGTERM handler included, which swallows the first signal:
    # Pool.terminate() kills workers by SIGTERM, so an inherited handler
    # would make them unkillable (the pool join hangs, one pool leaks per
    # epoch, interpreter exit deadlocks). Preemption belongs to the parent.
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    # Ctrl-C reaches the whole foreground process group; the parent turns it
    # into a graceful stop and terminates the pool, so workers ignore it.
    signal.signal(signal.SIGINT, signal.SIG_IGN)

    global _FORK_POOL_DATASET
    _FORK_POOL_DATASET = dataset
    _reseed_forked_rngs(dataset, epoch_seed)
    try:  # no cv2 thread oversubscription inside workers
        import cv2

        cv2.setNumThreads(0)
    except ImportError:
        pass


def _fork_build_batch(idxs):
    ds = _FORK_POOL_DATASET
    return _collate([ds[int(i)] for i in idxs])


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
    half the available RAM, 'on' forces, 'off' disables. Preloading before
    the process workers start means they inherit the cache copy-on-write
    (plain numpy arrays: nothing pinned, which a fork would not carry)."""
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


WORKER_MODES = ("thread", "process", "forkserver", "spawn")


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
        if worker_mode not in WORKER_MODES:
            raise ValueError(f"worker_mode {worker_mode!r}: one of {WORKER_MODES}")
        self.worker_mode = worker_mode if self.num_workers else "thread"

    def set_epoch(self, epoch: int) -> None:
        """Pin the ABSOLUTE epoch the next ``__iter__`` belongs to.

        Shuffle order and the process workers' seeds derive from ``(seed,
        epoch)``, not from a stateful RNG: a run resumed at epoch k
        (``--resume latest`` after preemption) must see epoch k's
        permutation and augmentation streams, not replay epoch 0's.
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
        elif self.worker_mode != "thread":
            thread = self._process_producer(batches, epoch_rng, put_checked, stop)
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

    def _process_producer(self, batches, epoch_rng, put_checked, stop) -> threading.Thread:
        """The producer thread of one epoch in a process mode: a fresh pool
        (forked from the calling thread in 'process' mode, so the children
        inherit only this moment's state), its workers seeded from a seed
        drawn from the epoch's generator, ``prefetch + num_workers`` batches
        in flight, results in submission order."""
        import multiprocessing as mp

        ctx = mp.get_context("fork" if self.worker_mode == "process" else self.worker_mode)
        epoch_seed = int(epoch_rng.integers(2**31 - 1))
        pool = ctx.Pool(self.num_workers, initializer=_fork_worker_init,
                        initargs=(self.dataset, epoch_seed))
        # the worker handles, pinned now: the SIGKILL escalation must not
        # depend on Pool._pool still existing at teardown
        workers = list(getattr(pool, "_pool", None) or [])
        deadline = worker_deadline_s()

        def get_checked(result):
            """``AsyncResult.get`` with a heartbeat: the pool silently loses
            the task of a killed worker (an OOM kill), so poll, honour the
            consumer's stop, and raise once no result came within the
            deadline."""
            waited = 0.0
            while not stop.is_set():
                try:
                    return result.get(timeout=1.0)
                except mp.TimeoutError:
                    waited += 1.0
                    if deadline and waited >= deadline:
                        raise RuntimeError(
                            f"dataloader worker produced no batch for {int(waited)}s: a "
                            "worker likely died (OOM-killed?) and its task is lost. Reduce "
                            "num_workers or the memory per sample, or raise "
                            "JARVIS_WORKER_DEADLINE_S.") from None
            return None

        def produce():
            it = iter(batches)
            pending: deque = deque()

            def submit_next() -> bool:
                idxs = next(it, None)
                if idxs is None:
                    return False
                pending.append(pool.apply_async(_fork_build_batch, ([int(i) for i in idxs],)))
                return True

            try:
                for _ in range(self.prefetch + self.num_workers):
                    if not submit_next():
                        break
                while pending:
                    batch = get_checked(pending.popleft())
                    if batch is None:  # consumer gone
                        return
                    submit_next()
                    if not put_checked(batch):
                        return
                put_checked(None)
            except BaseException as e:  # propagate to the consumer
                put_checked(_ProducerError(e))
            finally:
                pool.terminate()
                # Pool.join has no timeout, and a wedged worker (stuck in
                # uninterruptible IO) would hang it: bound it, then SIGKILL
                joiner = threading.Thread(target=pool.join, daemon=True)
                joiner.start()
                joiner.join(timeout=10.0)
                if joiner.is_alive():  # pragma: no cover - escalation
                    for p in workers:
                        if p.is_alive():
                            p.kill()
                    joiner.join(timeout=5.0)

        return threading.Thread(target=produce, daemon=True)
