"""The synthetic camera rig shared by the port's tests and chip_smoke.py."""

import numpy as np
import torch

from jarvis_hybridnet_torch.testing import synthetic_rig
from jarvis_hybridnet_torch.utils.reprojection import project_points


def test_synthetic_rig_sees_the_cube_and_distorts():
    rig = synthetic_rig(12, 1280, 1024)
    P, K, D = (torch.from_numpy(a) for a in (rig.camera_matrices, rig.intrinsics,
                                              rig.distortions))
    corners = torch.tensor([[x, y, z] for x in (-72.0, 72.0) for y in (-72.0, 72.0)
                            for z in (-72.0, 72.0)])
    uv = project_points(corners, P, K, D)  # (8, 12, 2)
    assert uv.shape == (8, 12, 2)
    assert ((uv[..., 0] > 0) & (uv[..., 0] < 1280)).all()
    assert ((uv[..., 1] > 0) & (uv[..., 1] < 1024)).all()
    # every camera looks inward: all corners in front of it
    hom = torch.cat([corners, torch.ones(8, 1)], dim=1)
    assert (torch.einsum("nk,ckm->cnm", hom, P)[..., 2] > 0).all()
    # the k1/k2 terms move a projected cube corner by more than a pixel
    undistorted = project_points(corners, P, K, torch.zeros_like(D))
    assert (uv - undistorted).norm(dim=-1).max() > 1.0
    assert np.all(rig.distortions[:, 0, :2] != 0)
