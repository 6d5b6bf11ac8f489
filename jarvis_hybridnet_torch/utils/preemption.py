"""Preemption-safe training on one process (the single-process part of
``jarvis_hybridnet_tpu/utils/preemption.py``).

``PreemptionGuard`` turns SIGTERM / SIGINT into a clean stop: it installs
signal handlers for the duration of a training run, the trainer polls
``guard.should_stop`` at step boundaries, and on a request it writes a full
resumable train state (``training.checkpoints.save_train_state``) and
returns with ``results["preempted"] = True``. The next run passes
``resume_from=<savepath>/train_state.ckpt`` and continues; the partial
epoch is re-run from its start (data order is epoch-deterministic).

A second signal while the guard is active restores the previous handler
and re-raises it, so a stuck save can still be killed the normal way.
On one process ``should_stop_global`` is ``should_stop``; the pod-wide
agreement waits for multi-device training (ROADMAP.md A.12).
"""

from __future__ import annotations

import os
import signal
import threading

from . import clp

DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)

# the JAX package's in-step cadence of the pod stop collective; on one
# process every poll reads the local flag
POD_POLL_STRIDE = 16


class PreemptionGuard:
    """Context manager that converts termination signals into a polled
    stop request. Only usable from the main thread (POSIX signal rule);
    anywhere else it degrades to a manual ``request_stop()`` flag."""

    def __init__(self, signals=DEFAULT_SIGNALS):
        self._signals = tuple(signals)
        self._pid = os.getpid()
        self._stop = threading.Event()
        self._prev: dict[int, object] = {}
        self._installed = False

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            self._pid = os.getpid()
            for sig in self._signals:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            self._installed = True
        return self

    def __exit__(self, *exc):
        if self._installed:
            for sig, prev in self._prev.items():
                signal.signal(sig, prev)
            self._prev.clear()
            self._installed = False
        return False

    def _on_signal(self, signum, frame):
        if os.getpid() != self._pid:  # a forked child: die normally
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        if self._stop.is_set():
            # second signal: restore the previous handler and re-deliver
            prev = self._prev.get(signum, signal.SIG_DFL)
            if prev is None or prev == signal.SIG_IGN:
                prev = signal.SIG_DFL
            signal.signal(signum, prev)
            signal.raise_signal(signum)
            return
        self._stop.set()
        clp.warning(
            f"Received signal {signal.Signals(signum).name}: finishing the "
            "current step, saving a resumable train state, then exiting. "
            "Send again to terminate immediately."
        )

    def request_stop(self) -> None:
        """Manual trigger (tests, schedulers with their own signal plumbing)."""
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def should_stop_global(self, stride: int = 1) -> bool:
        """On one process, the local flag (``stride`` is the JAX package's
        pod polling cadence and changes nothing here)."""
        del stride
        return self.should_stop

