"""The sharded HybridNet train step (``parallel/train_step.py``) on real gloo
ranks, against the port's single-process step and the JAX package's
sharded step, on the CPU.

On the small rig of ``test_torch_training.py`` (4 cameras, 128^2 crops, a
48 mm cube at 4 mm: G = 12, the committed MonkeyHand checkpoint, float32)
and a global batch of the two val framesets:

- a 2 x 2 mesh (two data groups of two camera ranks) and a 1 x 2 mesh (one
  data group, two camera ranks), each in freeze modes ``3D_only`` and
  ``all`` and repro modes quarter_fused and exact, two SGD steps in
  ``train()`` (dropout and drop-connect on: every rank draws the global
  batch's masks and keeps its part), against ``HybridNetTrainer``'s step on
  the whole batch in one process: the loss within 1e-6 relative, the
  points within 1e-3 mm on the first step and 1e-2 mm on the second
  (measured 1.4e-4 and 2.7e-3: the camera sum adds the partial volumes in
  another order), every gradient and update within
  ``test_torch_parallel.STEP_TOL``, every rank's parameters bit-equal to
  each other after each step;
- the loss of the 2 x 2 step (in ``eval()``) against JAX's
  ``make_hybridnet_train_step`` on a ``make_mesh(2, 2)`` mesh of the CPU
  devices with ``shard_cameras`` (as ``tests/test_parallel.py`` builds it,
  made deterministic as JAX's ``deterministic=True``), at that test's rtol
  of 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
from jarvis_hybridnet_torch.training.trainer3d import BATCH_KEYS
from jarvis_hybridnet_torch.utils.ckpt_io import read_ckpt
from jarvis_hybridnet_tpu.models.hybridnet import HybridNetBackbone as JaxHybridNet
from jarvis_hybridnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from jarvis_hybridnet_tpu.parallel.train_step import make_hybridnet_train_step
from tests import torch_parallel_ranks as ranks
from tests.test_torch_models import few_torch_threads  # noqa: F401
from tests.test_torch_parallel import STEP_TOL, close_grads, close_updates
from tests.test_torch_training import CUBE, SPACING, parent  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")
pytest.importorskip("cv2")

COMBOS = (("all", "quarter_fused"), ("3D_only", "exact"), ("3D_only", "quarter_fused"),
          ("all", "exact"))


def _global_batch(parent):  # noqa: F811
    cfg = ranks.project_cfg(parent)
    ds = Dataset3D(cfg, set="val", device_targets=True)
    samples = [ds[i] for i in range(2)]
    return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in BATCH_KEYS}


@pytest.fixture(scope="module")
def batch(parent):  # noqa: F811
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JARVIS_PARENT_DIR", parent)
        return _global_batch(parent)


@pytest.fixture(scope="module")
def single(parent, batch):  # noqa: F811
    """The single-process steps of every combination on the whole batch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JARVIS_PARENT_DIR", parent)
        return {(mode, repro): ranks.hybridnet_steps(ranks.project_cfg(parent, REPRO_MODE=repro),
                                                     batch, mode, None,
                                                     run_name=f"one_{mode}_{repro}")
                for mode, repro in COMBOS}


@pytest.mark.parametrize("n_data,n_cam", [(2, 2), (1, 2)])
def test_sharded_3d_step_matches_one_process(parent, batch, single, tmp_path, n_data,  # noqa: F811
                                             n_cam):
    got = ranks.run_ranks(ranks.train3d, n_data * n_cam, tmp_path, parent, n_data, n_cam,
                          COMBOS, batch)
    for combo in COMBOS:
        want = single[combo]
        for step in range(2):
            loss = want["loss"][step]
            assert abs(got[0][combo]["loss"][step] - loss) <= 1e-6 * abs(loss), combo
            points = torch.cat([got[d * n_cam][combo]["points"][step] for d in range(n_data)])
            assert float((points - want["points"][step]).abs().max()) <= (1e-3, 1e-2)[step], combo
            tol = STEP_TOL[combo[0]][step]
            if tol is not None:
                close_grads(got[0][combo]["grads"][step], want["grads"][step], tol[0])
                before = want["params"][step - 1] if step else want["before"]
                close_updates(got[0][combo]["params"][step], want["params"][step], before,
                              want["grads"][step], tol[1])
            for r in range(1, n_data * n_cam):
                assert got[r][combo]["loss"][step] == got[0][combo]["loss"][step]
                for n, p in got[0][combo]["params"][step].items():
                    assert torch.equal(p, got[r][combo]["params"][step][n]), (combo, r, n)
        trained = set(want["grads"][0])
        if combo[0] == "all":  # the 2D net trains: its gradients came through the camera sum
            assert any(n.startswith("effTrack.") for n in trained)
        else:
            assert all(n.startswith("v2vNet.") for n in trained)


class _Deterministic:
    """JAX's HybridNet as ``make_hybridnet_train_step`` calls it, with
    dropout and drop-connect off (``deterministic=True``)."""

    def __init__(self, model):
        self.model = model
        self.roi_cube_size, self.grid_spacing = model.roi_cube_size, model.grid_spacing

    def apply(self, variables, *args, deterministic, rngs):
        del deterministic, rngs
        return self.model.apply(variables, *args, deterministic=True)


def test_sharded_3d_loss_matches_jax_sharded_step(parent, batch, tmp_path):  # noqa: F811
    model = JaxHybridNet(num_joints=23, model_size="small", roi_cube_size=CUBE,
                         grid_spacing=SPACING, repro_mode="quarter_fused")
    params = jax.tree.map(jnp.asarray, read_ckpt(ranks.HYBRID))
    tx = optax.adamw(1e-3)
    step = make_hybridnet_train_step(_Deterministic(model), tx, jax_make_mesh(2, 2),
                                     shard_cameras=True)
    _, _, want = step(params, tx.init(params), jax.random.PRNGKey(0), batch)
    got = ranks.run_ranks(ranks.train3d_eval, 4, tmp_path, parent, batch)
    assert got[0] == got[1] == got[2] == got[3]
    np.testing.assert_allclose(got[0], float(want), rtol=2e-4)
