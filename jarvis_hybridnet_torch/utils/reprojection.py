"""Projective geometry on tensors (port of
``jarvis_hybridnet_tpu/utils/reprojection.py``).

Layouts follow the calibration convention: camera matrices (C, 4, 3), so a
homogeneous row vector projects as ``[X, Y, Z, 1] @ P``; intrinsics are the
transposed K (``[0,0]=fx, [1,1]=fy, [2,0]=cx, [2,1]=cy``); distortion is
radial k1, k2 only. Everything runs in float32: camera matrices fold K into
the extrinsics, so products reach ~1e6 and TF32 would cost pixels (matmul
TF32 is off by default in PyTorch; nothing here turns it on).
"""

from __future__ import annotations

import torch


def _distort_terms(intrinsics, distortions):
    fx, fy = intrinsics[:, 0, 0], intrinsics[:, 1, 1]
    cx, cy = intrinsics[:, 2, 0], intrinsics[:, 2, 1]
    k1, k2 = distortions[:, 0, 0], distortions[:, 0, 1]
    return fx, fy, cx, cy, k1, k2


def project_points(points3d: torch.Tensor, camera_matrices: torch.Tensor,
                   intrinsics: torch.Tensor, distortions: torch.Tensor) -> torch.Tensor:
    """World points (..., 3) mm -> (..., C, 2) distorted pixels."""
    shape = points3d.shape[:-1]
    flat = points3d.reshape(-1, 3).float()
    hom = torch.cat([flat, torch.ones_like(flat[:, :1])], dim=-1)  # (N, 4)
    proj = torch.einsum("nk,ckm->cnm", hom, camera_matrices)  # (C, N, 3)
    fx, fy, cx, cy, k1, k2 = (t[:, None] for t in
                              _distort_terms(intrinsics, distortions))
    u = proj[:, :, 0] / proj[:, :, 2] - cx
    v = proj[:, :, 1] / proj[:, :, 2] - cy
    r2 = torch.square(u / fx) + torch.square(v / fy)
    distort = 1.0 + (k1 + k2 * r2) * r2
    u = u * distort + cx
    v = v * distort + cy
    out = torch.stack([u, v], dim=-1)  # (C, N, 2)
    return torch.movedim(out, 0, -2).reshape(*shape, out.shape[0], 2)


def undistort_points_approx(points2d: torch.Tensor, intrinsics: torch.Tensor,
                            distortions: torch.Tensor) -> torch.Tensor:
    """(..., C, 2) distorted pixels -> approximately undistorted pixels:
    divide by the forward factor at the distorted radius."""
    fx, fy, cx, cy, k1, k2 = _distort_terms(intrinsics, distortions)
    u = points2d[..., 0] - cx
    v = points2d[..., 1] - cy
    r2 = torch.square(u / fx) + torch.square(v / fy)
    distort = 1.0 + (k1 + k2 * r2) * r2
    return torch.stack([u / distort + cx, v / distort + cy], dim=-1)


def triangulate(points2d: torch.Tensor, weights: torch.Tensor,
                camera_matrices: torch.Tensor, intrinsics: torch.Tensor,
                distortions: torch.Tensor) -> torch.Tensor:
    """Confidence-weighted DLT of one point per batch row.

    points2d (T, C, 2) distorted pixels, weights (T, C) -> (T, 3) mm. Rows
    ``[u, v]^T P_row2 - P_rows01`` scaled by the weights; the inhomogeneous
    system ``A[:, :3] x = -A[:, 3]`` is solved by QR least squares, as the
    JAX package does. A degenerate A (all weights 0) yields non-finite
    values, not an error; callers mask them.
    """
    und = undistort_points_approx(points2d, intrinsics, distortions)
    P = camera_matrices.transpose(1, 2)  # (C, 3, 4) rows of P
    A = und[..., None] * P[:, 2:3, :] - P[:, 0:2, :]  # (T, C, 2, 4)
    A = A * weights[..., None, None]
    A = A.reshape(A.shape[0], -1, 4)
    q, r = torch.linalg.qr(A[..., :3])
    rhs = (q.transpose(1, 2) @ -A[..., 3:4])
    return torch.linalg.solve_triangular(r, rhs, upper=True)[..., 0]
