"""The port's multi-device layer (``jarvis_hybridnet_torch/parallel/``) on the CPU.

- The integers against the JAX package's, each over a sweep:
  ``process_batch_slice``, ``process_frame_range``,
  ``plan_inference_devices``, the training meshes' factors for 1-8 ranks
  (JAX's ``auto_train_mesh`` / ``auto_data_mesh`` on the first n of the
  8 CPU devices ``conftest.py`` forces), and ``MultiHostLoader``'s epoch
  order and each rank's indices across epochs.
- The gathers' ``c_total`` (K2, K5, K11, K12 through their plain versions):
  a camera shard divided by the rig's camera count, summed over the
  shards, gives the whole rig's volume in every repro mode, and each
  shard's backward is the whole rig's sliced by camera.
- ``layers.DrawShard``: the ranks' parts of the global draw are the
  single-process draw.
- Real gloo ranks (``tests/torch_parallel_ranks.py``): the data-parallel
  2D step against the single-process step, and preemption (a stop signalled
  on one rank stops both at the same step; rank 0 alone writes).
"""

import jax
import numpy as np
import pytest
import torch

from jarvis_hybridnet_torch.kernels.repro_gather import (
    pad_rows,
    repro_quarter_gather_backward_plain,
)
from jarvis_hybridnet_torch.kernels.repro_grid_gather import repro_grid_gather_backward_plain
from jarvis_hybridnet_torch.models.layers import DrawShard
from jarvis_hybridnet_torch.models.repro import reproject_rows
from jarvis_hybridnet_torch.parallel import mesh as port_mesh
from jarvis_hybridnet_torch.parallel import multihost as port_multihost
from jarvis_hybridnet_tpu.parallel import mesh as jax_mesh
from jarvis_hybridnet_tpu.parallel import multihost as jax_multihost
from tests import torch_parallel_ranks as ranks
from tests.test_torch_models import few_torch_threads  # noqa: F401
from tests.test_torch_training import parent  # noqa: F401
from tests.test_torch_training_modes import _repro_inputs

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def test_process_slices_match_jax():
    for pc in range(1, 9):
        for pi in range(pc):
            for batch in (pc, 2 * pc, 6 * pc):
                assert (port_multihost.process_batch_slice(batch, pi, pc)
                        == jax_multihost.process_batch_slice(batch, pi, pc))
            for n in range(0, 40):
                assert (port_multihost.process_frame_range(n, pi, pc)
                        == jax_multihost.process_frame_range(n, pi, pc))
        if pc > 1:
            with pytest.raises(ValueError):
                port_multihost.process_batch_slice(pc + 1, 0, pc)


def test_plan_inference_devices_matches_jax():
    for world in range(1, 9):
        ranks_ = list(range(world))
        for cap in (-1, 1, 2, 3, 4):
            for n_cam in (1, 2, 3, 4):
                for cams in (4, 6, 12):
                    assert (port_mesh.plan_inference_devices(ranks_, cap, n_cam, cams)
                            == jax_mesh.plan_inference_devices(ranks_, cap, n_cam, cams))


@pytest.mark.parametrize("world", range(1, 9))
def test_training_mesh_factors_match_jax(world, monkeypatch):
    devices = jax.devices()[:world]
    monkeypatch.setattr(jax_mesh.jax, "devices", lambda: devices)
    for batch in (1, 2, 3, 4, 6, 8):
        for cams in (1, 2, 3, 4, 6, 12):
            got = port_mesh.train_mesh_shape(world, batch, cams)
            mesh = jax_mesh.auto_train_mesh(batch, cams)
            want = (1, 1) if mesh is None else (mesh.shape["data"], mesh.shape["cameras"])
            assert got == want, (world, batch, cams)
        got = port_mesh.data_mesh_shape(world, batch)
        mesh = jax_mesh.auto_data_mesh(batch)
        assert got == (1 if mesh is None else mesh.shape["data"]), (world, batch)


def test_multihost_loader_order_matches_jax():
    class _Range:
        def __init__(self, n):
            self.n = n

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            return {"i": np.asarray(i)}

    for n, batch, pc in ((13, 4, 2), (24, 6, 3), (10, 2, 1), (16, 8, 4)):
        ds = _Range(n)
        for shuffle in (False, True):
            got_all = []
            for pi in range(pc):
                port = port_multihost.MultiHostLoader(ds, batch, shuffle=shuffle, seed=5,
                                                      num_workers=0, process_index=pi,
                                                      process_count=pc)
                jax_ = jax_multihost.MultiHostLoader.__new__(jax_multihost.MultiHostLoader)
                jax_.dataset, jax_.global_batch_size, jax_.shuffle = ds, batch, shuffle
                jax_.seed, jax_._lo, jax_._hi = 5, *jax_multihost.process_batch_slice(
                    batch, pi, pc)
                assert len(port) == n // batch
                for epoch in (0, 1, 7):
                    order = port._epoch_order(epoch)
                    np.testing.assert_array_equal(order, jax_._epoch_order(epoch))
                    np.testing.assert_array_equal(port._local_indices(order),
                                                  jax_._local_indices(order))
                port.set_epoch(1)
                got = [b["i"].tolist() for b in port]
                got_all.append(got)
                want = port._local_indices(port._epoch_order(1)).reshape(-1, batch // pc)
                assert got == want.tolist()
            # the data groups' slices tile each global batch
            for k in range(n // batch):
                glob = sorted(sum((g[k] for g in got_all), []))
                assert len(set(glob)) == batch


def test_no_fallback_to_one_process_or_to_gloo(monkeypatch):
    """With ``WORLD_SIZE`` > 1 and no CUDA, joining the world raises rather
    than dropping to one process or to gloo; with it unset nothing is
    joined; a gloo mesh's step on the card cannot be captured."""
    import types

    from jarvis_hybridnet_torch.training.graphed import check_capturable

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert port_multihost.initialize_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL needs CUDA"):
        port_multihost.initialize_distributed()
    gloo = types.SimpleNamespace(backend="gloo")
    with pytest.raises(ValueError, match="cannot be captured"):
        check_capturable(True, "cuda", gloo)
    check_capturable(False, "cuda", gloo)
    check_capturable(True, "cpu", gloo)
    check_capturable(True, "cuda", types.SimpleNamespace(backend="nccl"))


@pytest.mark.parametrize("mode", ["exact", "half", "half_fused", "quarter_fused"])
def test_camera_shards_sum_to_the_rig_volume(mode):
    """Each reprojection mode on two camera shards of a 4-camera rig, each
    divided by the rig's 4 cameras, summed (the camera group's all-reduce
    on the mode's output, after the value upsample where there is one):
    the whole rig's volume within float32 round-off (measured 2.4e-7 of the
    largest value at most); the indices of each shard are the rig's sliced
    by camera, bit for bit. Then the backward (K11 / K12's plain versions):
    each shard's row gradient with ``c_total`` 4 equals the rig's sliced by
    camera, bit for bit."""
    heatmaps, center3d, center_hm, cams = _repro_inputs()
    B, C, J, hs, _ = heatmaps.shape
    rows = pad_rows(torch.from_numpy(heatmaps).permute(0, 1, 3, 4, 2).reshape(B, C, hs * hs, J))
    t = [torch.from_numpy(a) for a in (center3d, center_hm, *cams)]
    full, idx = reproject_rows(rows, t[0], t[1], *t[2:], 12, 4.0, mode, return_indices=True)
    total = torch.zeros_like(full)
    for sl in (slice(0, 2), slice(2, 4)):
        part, pidx = reproject_rows(pad_rows(rows[:, sl]), t[0], t[1][:, sl],
                                    *(a[:, sl] for a in t[2:]), 12, 4.0, mode,
                                    return_indices=True, c_total=C)
        assert torch.equal(pidx, idx[:, sl])
        total += part
    assert float((total - full).abs().max()) <= 1e-6 * float(full.abs().max())
    up = torch.from_numpy(np.random.default_rng(2).standard_normal(full.shape).astype(np.float32))
    if mode == "quarter_fused":
        def back(i, ct=None):
            return repro_quarter_gather_backward_plain(up, i, hs * hs, J, ct)
    else:
        def back(i, ct=None):
            return repro_grid_gather_backward_plain(up, i, hs * hs, J, mode, ct)
    whole = back(idx)
    for sl in (slice(0, 2), slice(2, 4)):
        assert torch.equal(back(idx[:, sl].contiguous(), C), whole[:, sl])
    with pytest.raises(ValueError, match="c_total"):
        reproject_rows(rows, t[0], t[1], *t[2:], 12, 4.0, mode, c_total=C - 1)


def test_draw_shards_are_the_single_process_draw():
    """Dropout's (B, ch, ...) and drop-connect's (B * C,) draws: the parts a
    2 x 2 mesh's ranks keep are the single-process draw's blocks, and every
    rank's generator ends where the single process's does."""
    B, C, shape = 4, 6, (3, 5)
    gen = torch.Generator().manual_seed(11)
    whole = torch.rand((B * C,) + shape, generator=gen)
    end = torch.rand(1, generator=gen)
    whole_v = torch.rand((B, 7), generator=torch.Generator().manual_seed(3))
    for d in range(2):
        for k in range(2):
            gen = torch.Generator().manual_seed(11)
            got = DrawShard(2, d, 2, k, C // 2).rand((B // 2 * C // 2,) + shape, gen, "cpu")
            want = whole.reshape(B, C, *shape)[d * 2:(d + 1) * 2, k * 3:(k + 1) * 3]
            assert torch.equal(got, want.reshape(got.shape))
            assert torch.equal(torch.rand(1, generator=gen), end)
            got_v = DrawShard(2, d).rand((B // 2, 7), torch.Generator().manual_seed(3), "cpu")
            assert torch.equal(got_v, whole_v[d * 2:(d + 1) * 2])


ROUND_OFF = 1e-4  # a gradient whose largest is under this share of the largest over tensors
# The sharded steps against the single-process step on the whole batch, two
# SGD steps: (gradients, updates) of the first and of the second step, each
# tensor within that share of its largest element (``close_grads``,
# ``close_updates``); None: not compared. The gradients differ by the
# float32 round-off of sums taken in another order, measured (first /
# second step): 2D 1.5e-6 / 8.0e-5; 3D_only 1.5e-5 / 5.5e-5; ``all``
# 1.3e-4 (exact) on the first step. In ``all`` the second step's gradients
# are not compared: the 2D net's backward is so ill-conditioned in float32
# that the first step's round-off in the parameters moves some of them by
# 7e-2 of their largest (JAX's own float32 run lies 8.6e-2 from float64
# there, ROADMAP.md section C); its loss and the ranks' agreement still are.
# AdamW is not used here: its first update is about lr * g / |g| element by
# element, so an element whose gradient is within round-off of zero moves
# by lr either way.
STEP_TOL = {"2d": ((1e-5, 1e-5), (2e-4, 2e-4)),
            "3D_only": ((5e-5, 5e-5), (2e-4, 2e-4)),
            "all": ((5e-4, 5e-4), None)}


def round_off(grads: dict) -> set:
    """The tensors whose gradient is round-off: the largest element under
    ``ROUND_OFF`` of the largest over all tensors (the biases ahead of an
    InstanceNorm, whose gradient is zero in exact arithmetic; measured
    2e-9 to 2e-7 of the largest)."""
    top = max(float(g.abs().max()) for g in grads.values())
    return {n for n, g in grads.items() if float(g.abs().max()) < ROUND_OFF * top}


def close_grads(got: dict, want: dict, tol: float) -> float:
    """Every gradient of ``got`` within ``tol`` of its ``want`` tensor's
    largest element, a round-off tensor's within ``tol`` of the largest over
    all tensors. Returns the worst reading in units of its scale."""
    assert set(got) == set(want)
    top = max(float(g.abs().max()) for g in want.values())
    noise = round_off(want)
    worst = 0.0
    for name, g in want.items():
        scale = top if name in noise else float(g.abs().max())
        err = float((got[name] - g).abs().max()) / max(scale, 1e-30)
        assert err <= tol, (name, err)
        worst = max(worst, err)
    return worst


def close_updates(got: dict, want: dict, before: dict, grads: dict, tol: float) -> float:
    """Each tensor's update (``got`` / ``want`` less ``before``) within
    ``tol`` of its ``want`` update's largest element, beyond two float32
    ulps of each parameter (the parameter's own rounding after an update
    that differs by round-off); a tensor whose gradient is round-off
    (``round_off``) within ``tol`` of the largest update over all tensors.
    Returns the worst reading."""
    noise = round_off(grads)
    moves = {n: want[n] - before[n] for n in before}
    top = max(float(m.abs().max()) for m in moves.values())
    worst = 0.0
    for name, w in want.items():
        ulp = (torch.nextafter(w.abs(), torch.full_like(w, float("inf"))) - w.abs())
        excess = ((got[name] - w).abs() - 2 * ulp).clamp(min=0)
        scale = top if name in noise else float(moves[name].abs().max())
        err = float(excess.max()) / max(scale, 1e-30)
        assert err <= tol, (name, err)
        worst = max(worst, err)
    return worst


def test_data_parallel_2d_step_matches_one_process(parent, tmp_path, monkeypatch):  # noqa: F811
    """Two gloo ranks of KeypointDetect's data-parallel step (in
    ``train()``, drop-connect on), a global batch of 4 at 64^2, two SGD
    steps, against the single-process step on the whole batch: the loss
    within 1e-6 relative, every gradient and update within ``STEP_TOL``
    of its tensor's largest (the round-off ones as ``close_grads`` and
    ``close_updates`` say), the argmax identical, the ranks' parameters
    bit-equal to each other."""
    monkeypatch.setenv("JARVIS_PARENT_DIR", parent)
    rng = np.random.default_rng(4)
    batch = {"imgs": rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8),
             "kxy": rng.uniform(4, 60, (4, 23, 2)).astype(np.float32)}
    want = ranks.efficienttrack_steps(ranks.project_cfg(parent), batch, None, run_name="one2d")
    got = ranks.run_ranks(ranks.train2d, 2, tmp_path, parent, batch)
    for step in range(2):
        assert abs(got[0]["loss"][step] - want["loss"][step]) <= 1e-6 * abs(want["loss"][step])
        assert got[0]["loss"][step] == got[1]["loss"][step]
        assert torch.equal(torch.cat([g["xy"][step] for g in got]), want["xy"][step])
        before = want["params"][step - 1] if step else want["before"]
        grad_tol, update_tol = STEP_TOL["2d"][step]
        close_grads(got[0]["grads"][step], want["grads"][step], grad_tol)
        close_updates(got[0]["params"][step], want["params"][step], before,
                      want["grads"][step], update_tol)
        for n, p in got[0]["params"][step].items():
            assert torch.equal(p, got[1]["params"][step][n]), n


def test_a_stop_on_one_rank_stops_both_at_one_step(parent, tmp_path):  # noqa: F811
    """``HybridNetTrainer.train`` on two gloo ranks (3D_only, a global batch
    of 2, 2 epochs): rank 1 alone receives SIGTERM after its first step.
    Both ranks stop after the same number of steps (the epoch's end, where
    the unconditional poll runs) with ``preempted``, rank 0 alone writes
    ``train_state.ckpt`` and its run directory, and the ranks' parameters
    are bit-equal."""
    import os

    got = ranks.run_ranks(ranks.preempt, 2, tmp_path, parent, 1)
    assert got[0]["calls"] == got[1]["calls"] == [1, 1]
    assert got[0]["preempted"] and got[1]["preempted"]
    assert os.path.isfile(os.path.join(got[0]["savepath"], "train_state.ckpt"))
    assert not os.path.exists(got[1]["savepath"])
    for n, p in got[0]["params"].items():
        assert torch.equal(p, got[1]["params"][n]), n
