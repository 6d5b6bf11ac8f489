"""Preemption-safe training (port of
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

Several processes (``torch.distributed``): signal delivery is not
synchronized across ranks, so trainers poll ``should_stop_global()``, an
all-reduce (MAX) of the ranks' flags over the guard's ``group``, strided to
every ``POD_POLL_STRIDE``-th step and unconditional at epoch ends, which
makes every rank stop at the same boundary iff any rank saw a signal. Only
the primary rank (:func:`is_primary_host`, rank 0) writes checkpoints,
train states and logs (the parameters are replicated). Without a group
``should_stop_global`` is ``should_stop``.
"""

from __future__ import annotations

import os
import signal
import threading

from . import clp

DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)

# In-step cadence of the stop collective: at most this many extra steps run
# after a signal before the ranks agree to stop, at 1/16th the per-step cost.
POD_POLL_STRIDE = 16


class PreemptionGuard:
    """Context manager that converts termination signals into a polled
    stop request. Only usable from the main thread (POSIX signal rule);
    anywhere else it degrades to a manual ``request_stop()`` flag.
    ``group`` (a process group) and ``device`` (where its collective's
    tensor lives: the rank's GPU under NCCL) make ``should_stop_global``
    agree over the group's ranks."""

    def __init__(self, signals=DEFAULT_SIGNALS, group=None, device="cpu"):
        self._signals = tuple(signals)
        self._pid = os.getpid()
        self._stop = threading.Event()
        self._prev: dict[int, object] = {}
        self._installed = False
        self.group = group
        self.device = device
        self._calls = 0  # strided should_stop_global collective gate

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
        """Stop check on which all ranks of ``group`` agree at the same
        boundary: the MAX of their flags. With ``stride`` > 1 the collective
        runs on every ``stride``-th call only (the call COUNT gates it,
        never the local flag, so every rank joins the same collectives; all
        ranks must call with the same strides at the same boundaries).
        Without a group, the local flag."""
        if self.group is None:
            return self.should_stop
        self._calls += 1
        if stride > 1 and self._calls % stride:
            return False
        import torch
        import torch.distributed as dist

        flag = torch.tensor([int(self.should_stop)], dtype=torch.int32, device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        return bool(flag.item())


def is_primary_host() -> bool:
    """True on the process that writes shared checkpoints, train states and
    logs: rank 0, or the one process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0

