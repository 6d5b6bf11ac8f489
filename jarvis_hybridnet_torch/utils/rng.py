"""Thread-safe per-thread RNG streams for dataset workers (a copy of
``jarvis_hybridnet_tpu/utils/rng.py``).

The thread-pool :class:`~jarvis_hybridnet_torch.dataset.loader.DataLoader`
calls ``dataset.__getitem__`` from N worker threads concurrently, and
``np.random.Generator`` is documented as not thread-safe: N threads
mutating one shared PCG64 state produce duplicated or corrupted draws —
the same silent augmentation-diversity collapse the forked-process
reseed in ``dataset/loader.py`` exists to prevent, plus nondeterministic
state corruption. (The reference sidesteps this by using process-based
torch DataLoader workers only, jarvis/efficienttrack/efficienttrack.py:
210-224.)
"""

from __future__ import annotations

import threading

import numpy as np


class ThreadLocalGenerator:
    """``np.random.Generator`` facade giving each thread its own stream.

    Each thread lazily receives an independent child stream spawned from
    one root :class:`np.random.SeedSequence`; draws (``random``,
    ``uniform``, ``normal``, ...) proxy to the calling thread's
    generator. :meth:`reseed` swaps the root and discards per-thread
    state — used by forked process workers to decorrelate after fork.

    Pickles by root seed only (the ``threading.local`` and lock are
    rebuilt empty on unpickle): 'forkserver'/'spawn' loader workers
    receive the dataset by pickle, and their initializer reseeds every
    stream anyway (``dataset/loader._reseed_forked_rngs``); 'thread' and
    'process' (fork) workers share/inherit by reference and never
    pickle.
    """

    def __init__(self, seed=None):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._seq = (seed if isinstance(seed, np.random.SeedSequence)
                     else np.random.SeedSequence(seed))

    def __getstate__(self):
        return {"_seq": self._seq}

    def __setstate__(self, state):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._seq = state["_seq"]

    def reseed(self, seed=None) -> None:
        with self._lock:
            self._seq = (seed if isinstance(seed, np.random.SeedSequence)
                         else np.random.SeedSequence(seed))
            # fresh thread-local storage: existing threads re-derive from
            # the new root on their next draw
            self._tls = threading.local()

    def _gen(self) -> np.random.Generator:
        tls = self._tls
        g = getattr(tls, "gen", None)
        if g is None:
            with self._lock:
                child = self._seq.spawn(1)[0]
            g = np.random.default_rng(child)
            tls.gen = g
        return g

    def __getattr__(self, name):
        return getattr(self._gen(), name)
