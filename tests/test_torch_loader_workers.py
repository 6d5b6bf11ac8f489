"""The port's ``DataLoader`` in its process worker modes ('process',
'forkserver', 'spawn'), the counterpart of the JAX package's loader tests
(``tests/test_dataset.py:264-530``), and against the JAX package's loader.

Order equal to the serial loader in every process mode, errors that reach
the consumer, distinct streams per worker and per epoch, the
absolute-epoch order, the workers' signal dispositions under
``PreemptionGuard``, workers reaped over three epochs, forking after torch
CPU and autograd work, and a killed worker raising within a small
``JARVIS_WORKER_DEADLINE_S``. Against the JAX package: the reseed draws
JAX's streams for the same ``(epoch_seed, pid)``, and the loader in
'process' mode yields JAX's batches byte for byte on the same synthetic
``Dataset2D`` / ``Dataset3D`` (the val split, which draws nothing; and the
train split with its host augmentation, one worker and the pid pinned in
both, so that both draw the same streams).
"""

import multiprocessing as mp
import os
import signal
import time

import numpy as np
import pytest
import torch

from jarvis_hybridnet_torch.dataset import loader
from jarvis_hybridnet_torch.dataset.loader import DataLoader
from jarvis_hybridnet_torch.utils.preemption import PreemptionGuard
from jarvis_hybridnet_torch.utils.rng import ThreadLocalGenerator
from jarvis_hybridnet_tpu.dataset import loader as jax_loader
from jarvis_hybridnet_tpu.utils.rng import ThreadLocalGenerator as JaxThreadLocalGenerator

PROCESS_MODES = ("process", "forkserver", "spawn")

# the pid a forked worker reports while a test pins it (None: its own)
_CHILD_PID = {"pid": None}


def _pin_child_pid():
    if _CHILD_PID["pid"] is not None:
        pid = _CHILD_PID["pid"]
        os.getpid = lambda: pid


os.register_at_fork(after_in_child=_pin_child_pid)


class _PickleDS:
    """Module-level so that 'forkserver' / 'spawn' children unpickle it by
    reference."""

    def __len__(self):
        return 23

    def __getitem__(self, i):
        return {"x": np.full((3,), i, np.float32), "name": f"s{i}"}


def _leaked(before: set, grace: float = 20.0) -> set:
    """The worker processes started since ``before`` still alive after a
    bounded grace period (the producer threads terminate their pools
    asynchronously)."""
    deadline = time.monotonic() + grace
    while True:
        leaked = {p.pid for p in mp.active_children()} - before
        if not leaked or time.monotonic() > deadline:
            return leaked
        time.sleep(0.2)


@pytest.mark.parametrize("mode", PROCESS_MODES)
def test_process_modes_match_serial(mode):
    serial = list(DataLoader(_PickleDS(), batch_size=4, num_workers=0))
    procs = list(DataLoader(_PickleDS(), batch_size=4, num_workers=2, worker_mode=mode))
    assert len(serial) == len(procs) == 6
    for a, b in zip(serial, procs):
        np.testing.assert_array_equal(a["x"], b["x"])
        assert a["name"] == b["name"]


def test_unknown_worker_mode_raises():
    with pytest.raises(ValueError, match="worker_mode"):
        DataLoader(_PickleDS(), batch_size=4, worker_mode="fiber")
    # no workers: the serial loader, whatever the mode
    assert DataLoader(_PickleDS(), batch_size=4, num_workers=0,
                      worker_mode="process").worker_mode == "thread"


class _Bad:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom")
        return np.zeros((2,), np.float32)


@pytest.mark.parametrize("mode", ["process", "forkserver"])
def test_worker_errors_reach_the_consumer(mode):
    with pytest.raises(ValueError, match="boom"):
        for _ in DataLoader(_Bad(), batch_size=4, num_workers=2, worker_mode=mode):
            pass


class _Draws:
    """A dataset whose samples are draws of its own generator and of its
    ``augpipe``'s (a ThreadLocalGenerator, as the datasets' pipelines)."""

    def __init__(self):
        self.rng = np.random.default_rng(7)
        self.augpipe = type("Aug", (), {})()
        self.augpipe.rng = ThreadLocalGenerator(7)

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return np.array([self.rng.random(), self.augpipe.rng.random()], np.float64)


def test_distinct_streams_per_worker_and_epoch():
    dl = DataLoader(_Draws(), batch_size=4, num_workers=2, worker_mode="process")
    epoch1 = np.concatenate(list(dl))
    epoch2 = np.concatenate(list(dl))
    assert not np.allclose(epoch1[:4], epoch1[4:])  # one batch a worker
    assert not np.allclose(epoch1, epoch2)  # the next epoch's pool does not replay
    # a fresh loader pinned to epoch 1 draws with epoch 1's seed, not epoch 0's
    again = DataLoader(_Draws(), batch_size=4, num_workers=2, worker_mode="process")
    again.set_epoch(1)
    assert not np.allclose(np.concatenate(list(again)), epoch1)


class _Idx:
    def __len__(self):
        return 17

    def __getitem__(self, i):
        return np.asarray([i])


@pytest.mark.parametrize("workers,mode", [(0, "thread"), (2, "process")])
def test_epoch_order_follows_absolute_epoch(workers, mode):
    def order(dl):
        return np.concatenate([np.asarray(b).ravel() for b in dl])

    a = DataLoader(_Idx(), batch_size=4, shuffle=True, seed=5, num_workers=workers,
                   worker_mode=mode)
    e0, e1, e2 = order(a), order(a), order(a)
    assert not np.array_equal(e0, e1)
    b = DataLoader(_Idx(), batch_size=4, shuffle=True, seed=5, num_workers=workers,
                   worker_mode=mode)
    b.set_epoch(1)
    np.testing.assert_array_equal(order(b), e1)
    np.testing.assert_array_equal(order(b), e2)
    c = DataLoader(_Idx(), batch_size=4, shuffle=True, seed=6, num_workers=workers,
                   worker_mode=mode)
    c.set_epoch(1)
    assert not np.array_equal(order(c), e1)


class _Dispositions:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        return np.asarray([signal.getsignal(signal.SIGTERM) is signal.SIG_DFL,
                           signal.getsignal(signal.SIGINT) is signal.SIG_IGN], bool)


def test_worker_signal_dispositions_under_preemption_guard():
    """Inside a worker SIGTERM is SIG_DFL (``Pool.terminate()`` kills it) and
    SIGINT SIG_IGN, while the parent holds ``PreemptionGuard``'s
    handlers."""
    with PreemptionGuard():
        assert signal.getsignal(signal.SIGTERM) is not signal.SIG_DFL
        (batch,) = list(DataLoader(_Dispositions(), batch_size=4, num_workers=2,
                                   worker_mode="process"))
    assert batch.all(), batch


def test_workers_reaped_over_three_epochs_under_preemption_guard():
    before = {p.pid for p in mp.active_children()}
    with PreemptionGuard():
        dl = DataLoader(_Idx(), batch_size=4, num_workers=2, worker_mode="process")
        for _ in range(3):  # one fresh pool an epoch
            assert len(list(dl)) == 5
    assert not _leaked(before), "leaked loader workers"


def test_fork_after_torch_cpu_and_autograd_makes_progress():
    """The trainers fork their pools from a process whose torch is live
    (intra-op threads, autograd's engine): two process-pool epochs after
    heavy torch CPU work and a backward, under the guard, every batch
    arrives in order, no worker is left, and torch still computes."""
    torch.manual_seed(0)
    w = torch.randn(256, 256, requires_grad=True)
    for _ in range(4):
        (w @ w).tanh().sum().backward()
    before = {p.pid for p in mp.active_children()}
    with PreemptionGuard():
        dl = DataLoader(_PickleDS(), batch_size=4, num_workers=2, worker_mode="process", seed=3)
        for epoch in range(2):
            dl.set_epoch(epoch)
            got = [b["x"] for b in dl]
            assert len(got) == 6
            np.testing.assert_array_equal(np.concatenate(got)[:, 0],
                                          np.arange(23, dtype=np.float32))
    assert not _leaked(before)
    assert torch.isfinite((w @ w).sum()) and w.grad is not None


class _Suicide:
    """Kills its own worker at sample 5: the pool loses that task."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            os.kill(os.getpid(), signal.SIGKILL)
        return np.zeros((2,), np.float32)


def test_killed_worker_raises_within_the_deadline(monkeypatch):
    monkeypatch.setenv("JARVIS_WORKER_DEADLINE_S", "2")
    assert loader.worker_deadline_s() == 2.0
    before = {p.pid for p in mp.active_children()}
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="produced no batch"):
        for _ in DataLoader(_Suicide(), batch_size=4, num_workers=2, worker_mode="process"):
            pass
    assert time.monotonic() - t0 < 30.0
    assert not _leaked(before)


def _holder(generator_cls, thread_local_cls):
    ds = type("DS", (), {})()
    ds.rng = generator_cls(11) if generator_cls else np.random.default_rng(11)
    ds.aux = np.random.default_rng(12)
    ds.augpipe = type("Aug", (), {})()
    ds.augpipe.rng = thread_local_cls(13)
    return ds


def test_reseed_draws_the_jax_packages_streams(monkeypatch):
    """For the same ``(epoch_seed, pid)`` the port's ``_reseed_forked_rngs``
    gives every generator of a dataset and its ``augpipe`` the stream JAX's
    gives it."""
    monkeypatch.setattr(os, "getpid", lambda: 4242)
    port = _holder(None, ThreadLocalGenerator)
    ref = _holder(None, JaxThreadLocalGenerator)
    loader._reseed_forked_rngs(port, 987654)
    jax_loader._reseed_forked_rngs(ref, 987654)
    for get in (lambda d: d.rng, lambda d: d.aux, lambda d: d.augpipe.rng):
        np.testing.assert_array_equal(get(port).random(16), get(ref).random(16))
    # another pid, another stream
    other = _holder(None, ThreadLocalGenerator)
    monkeypatch.setattr(os, "getpid", lambda: 4243)
    loader._reseed_forked_rngs(other, 987654)
    port2 = _holder(None, ThreadLocalGenerator)
    monkeypatch.setattr(os, "getpid", lambda: 4242)
    loader._reseed_forked_rngs(port2, 987654)
    assert not np.array_equal(other.rng.random(4), port2.rng.random(4))


def test_a_view_pickles_for_clean_child_workers():
    """'forkserver' / 'spawn' workers unpickle the dataset: a per-rank view
    (``parallel/multihost``) pickles and reads its dataset's samples."""
    import pickle

    from jarvis_hybridnet_torch.parallel.multihost import _IndexView

    view = pickle.loads(pickle.dumps(_IndexView(_PickleDS(), np.array([4, 2]))))
    assert len(view) == 2 and view[1]["name"] == "s2" and len(view._dataset) == 23
    got = list(DataLoader(_IndexView(_PickleDS(), np.arange(20, 23)), batch_size=2,
                          num_workers=2, worker_mode="spawn"))
    assert [b["name"] for b in got] == [["s20", "s21"], ["s22"]]


def test_reseed_reaches_the_dataset_behind_a_view():
    """A per-rank view (``parallel/multihost``) holds no generator itself:
    the worker reseeds the dataset it wraps."""
    from jarvis_hybridnet_torch.parallel.multihost import _IndexView

    inner = _holder(None, ThreadLocalGenerator)
    state = inner.rng.bit_generator.state
    loader._reseed_forked_rngs(_IndexView(inner, np.arange(3)), 5)
    assert inner.rng.bit_generator.state != state


# --------------------------------------------- against the JAX package ---

@pytest.fixture(scope="module")
def parent(tmp_path_factory):
    pytest.importorskip("cv2")
    from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d, write_project

    root = tmp_path_factory.mktemp("parent")
    write_dataset3d(str(root / "datasets" / "Synth"), synthetic_rig(4, 320, 256), 320, 256, 3,
                    splits=(("train", 3), ("val", 2)), extent_mm=40.0, seed=7, unlabeled=(1,))
    write_project(str(root), "P", {
        "DATASET": {"DATASET_2D": "Synth", "DATASET_3D": "Synth"},
        "CENTERDETECT": {"MODEL_SIZE": "small", "IMAGE_SIZE": 64},
        "KEYPOINTDETECT": {"MODEL_SIZE": "small", "NUM_JOINTS": 3, "BOUNDING_BOX_SIZE": 64},
        "HYBRIDNET": {"ROI_CUBE_SIZE": 48, "GRID_SPACING": 4, "NUM_CAMERAS": 4},
        "AUGMENTATION": {"MIRROR": {"PROBABILITY": 0.5},
                         "AFFINE_TRANSFORM": {"PROBABILITY": 1.0}},
    })
    return str(root)


def _datasets(parent, kind, split):
    from jarvis_hybridnet_torch.config.project_manager import ProjectManager
    from jarvis_hybridnet_torch.dataset.dataset2d import Dataset2D
    from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
    from jarvis_hybridnet_tpu.config.project_manager import ProjectManager as JaxProjectManager
    from jarvis_hybridnet_tpu.dataset.dataset2d import Dataset2D as JaxDataset2D
    from jarvis_hybridnet_tpu.dataset.dataset3d import Dataset3D as JaxDataset3D

    port, ref = ProjectManager(parent), JaxProjectManager(parent_dir=parent)
    assert port.load("P") and ref.load("P")
    if kind == "HybridNet":
        return (Dataset3D(port.get_cfg(), set=split, device_targets=True),
                JaxDataset3D(ref.get_cfg(), set=split, device_targets=True))
    return (Dataset2D(port.get_cfg(), set=split, mode=kind, device_targets=True),
            JaxDataset2D(ref.get_cfg(), set=split, mode=kind, device_targets=True))


def _same_bytes(a, b, where):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same_bytes(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _same_bytes(u, v, f"{where}[{i}]")
    else:
        u, v = np.asarray(a), np.asarray(b)
        assert u.dtype == v.dtype and u.shape == v.shape, where
        assert u.tobytes() == v.tobytes(), where


@pytest.mark.parametrize("kind,split,workers", [
    ("CenterDetect", "val", 2), ("KeypointDetect", "val", 2), ("HybridNet", "val", 2),
    ("KeypointDetect", "train", 1), ("HybridNet", "train", 1)])
def test_process_batches_equal_the_jax_loaders(parent, monkeypatch, kind, split, workers):
    """Two shuffled epochs of the port's loader in 'process' mode against the
    JAX package's, batch for batch and byte for byte. The train split draws
    its host augmentation in the workers: with one worker and its pid pinned
    in both (``os.getpid`` replaced in the forked child), both reseed to the
    same streams."""
    before = {p.pid for p in mp.active_children()}
    if split == "train":
        monkeypatch.setitem(_CHILD_PID, "pid", 31337)
    port, ref = _datasets(parent, kind, split)
    batch = 1 if kind == "HybridNet" else 2
    mk = [cls(ds, batch_size=batch, shuffle=True, seed=4, num_workers=workers,
              worker_mode="process") for cls, ds in ((DataLoader, port),
                                                     (jax_loader.DataLoader, ref))]
    for epoch in (0, 1):
        for dl in mk:
            dl.set_epoch(epoch)
        got, want = list(mk[0]), list(mk[1])
        assert len(got) == len(want) == len(mk[0]) > 1
        for i, (a, b) in enumerate(zip(got, want)):
            _same_bytes(a, b, f"{kind} {split} epoch {epoch} batch {i}")
    assert not _leaked(before)
