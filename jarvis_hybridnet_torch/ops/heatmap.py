"""Heatmap decoding and training targets (port of
``jarvis_hybridnet_tpu/ops/heatmap.py``): the argmax (K10 on the card), the
2D Gaussian targets on the host and on the device (K8 builds them in its
loss), the 3D targets (K7 builds them in its loss)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

SIGMA_EXP_3D = 1.7  # the 3D target's exponent (heatmap.py:127)


def argmax_2d(heatmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel spatial argmax (the JAX package's ``ops/heatmap.py::
    argmax_2d``) of (..., H, W, C) heatmaps, read through their strides, by the
    op ``jarvis_torch::argmax2d``: the plain version on a CPU tensor, K10 on
    a CUDA tensor. Returns (xy (..., C,
    2) int32, maxvals (..., C) float32, exact for a bfloat16 input): the
    first maximal index m in row-major order, x = m % W, y = m // W."""
    from ..kernels.argmax2d import argmax2d  # the kernels import this module

    h, w, c = heatmaps.shape[-3:]
    lead = heatmaps.shape[:-3]
    xy, maxvals = argmax2d(heatmaps.reshape(-1, h, w, c))
    return xy.reshape(*lead, c, 2), maxvals.reshape(*lead, c)


def gaussian_heatmaps(keypoints: np.ndarray, input_size: int, output_size: int,
                      sigma: float) -> np.ndarray:
    """Host-side Gaussian targets (J, output_size, output_size) float32, a
    copy of the JAX package's ``gaussian_heatmaps`` (the reference
    HeatmapGenerator, jarvis/dataset/dataset2D.py:284-339): peak 255,
    integer-truncated center at output resolution, window of ``6*sigma + 3``
    px, points at (0, 0) or outside the map skipped."""
    scale = float(output_size) / float(input_size)
    size = int(6 * sigma + 3)
    x = np.arange(0, size, 1, float)
    y = x[:, np.newaxis]
    x0 = y0 = 3 * sigma + 1
    g = 255.0 * np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma**2))

    J = keypoints.shape[0]
    hms = np.zeros((J, output_size, output_size), dtype=np.float32)
    for idx, pt in enumerate(keypoints):
        if pt[0] == 0 and pt[1] == 0:
            continue
        cx, cy = int(pt[0] * scale), int(pt[1] * scale)
        if cx < 0 or cy < 0 or cx >= output_size or cy >= output_size:
            continue
        ul = (int(np.round(cx - 3 * sigma - 1)), int(np.round(cy - 3 * sigma - 1)))
        br = (int(np.round(cx + 3 * sigma + 2)), int(np.round(cy + 3 * sigma + 2)))
        # the stamp window clipped to both the map and the kernel
        a, b = max(0, -ul[1]), min(min(br[1], output_size) - ul[1], size)
        c, d = max(0, -ul[0]), min(min(br[0], output_size) - ul[0], size)
        aa, cc = max(0, ul[1]), max(0, ul[0])
        bb, dd = aa + (b - a), cc + (d - c)
        hms[idx, aa:bb, cc:dd] = np.maximum(hms[idx, aa:bb, cc:dd], g[a:b, c:d])
    return hms


@dataclasses.dataclass(frozen=True)
class Stamp:
    """The float32 constants of one scale's Gaussian target, as the JAX
    package's ``gaussian_heatmaps_on_device`` rounds them: ``scale`` out / in,
    ``off`` 3 sigma + 1 (the window corner's offset and the kernel's centre),
    ``den`` 2 sigma^2, ``ksize`` int(6 sigma + 3)."""

    out: int
    scale: float
    off: float
    den: float
    ksize: int


def stamp(input_size: int, output_size: int, sigma: float) -> Stamp:
    f32 = np.float32
    return Stamp(output_size, float(f32(float(output_size) / float(input_size))),
                 float(f32(3.0 * sigma + 1.0)), float(f32(2.0 * sigma * sigma)),
                 int(6 * sigma + 3))


def gaussian_heatmaps_on_device(kps: torch.Tensor, input_size: int, output_size: int,
                                sigma: float) -> torch.Tensor:
    """Gaussian targets (B, output_size, output_size, J) float32 of keypoints
    (B, J, 2) at input resolution, the JAX package's
    ``gaussian_heatmaps_on_device`` (:73): the truncated centre at output
    resolution, the window corner rounded half to even, ``int(6 sigma + 3)``
    wide, peak 255, (0, 0) keypoints and centres off the map skipped. The
    training step builds it inside K8 instead (``kernels/heatmap2d_loss.py``);
    this is K8's plain version's target."""
    from ..kernels.instance_norm import _exp  # the kernels import this module

    st = stamp(input_size, output_size, sigma)
    dev = kps.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    k = kps.to(torch.float32)
    c = torch.trunc(k * f32(st.scale))
    valid = ~((k[..., 0] == 0) & (k[..., 1] == 0))
    valid &= (c[..., 0] >= 0) & (c[..., 0] < output_size) & (c[..., 1] >= 0) \
        & (c[..., 1] < output_size)
    ul = torch.round(c - f32(st.off))  # half to even, as np.round
    r = torch.arange(output_size, dtype=torch.float32, device=dev)
    kx = r[None, None, :] - ul[..., 0][..., None]  # (B, J, W)
    ky = r[None, None, :] - ul[..., 1][..., None]  # (B, J, H)
    dy, dx = ky - f32(st.off), kx - f32(st.off)
    d2 = (dy * dy)[..., :, None] + (dx * dx)[..., None, :]
    g = 255.0 * _exp(-d2 / f32(st.den))
    inside = (((ky >= 0) & (ky < st.ksize))[..., :, None]
              & ((kx >= 0) & (kx < st.ksize))[..., None, :])
    hm = torch.where(inside & valid[..., None, None], g, torch.zeros_like(g))
    return torch.movedim(hm, 1, -1)


def gaussian_heatmaps_3d_on_device(kps_vox: torch.Tensor, kps_world: torch.Tensor,
                                   size: int) -> torch.Tensor:
    """3D Gaussian targets (B, size, size, size, J) float32: 255 * exp(-0.5 *
    d^2), d = (kps_vox - r) / 1.7 per axis, summed (x + y) + z as the JAX
    package sums them; zero for a joint whose ``kps_world`` row is all zero
    (unlabeled). The training step builds it inside K7 instead
    (``kernels/hybridnet_loss.py``); this is K7's plain version's target."""
    from ..kernels.instance_norm import _exp  # the kernels import this module

    r = torch.arange(size, dtype=torch.float32, device=kps_vox.device)
    d = (kps_vox.float()[..., None] - r) / SIGMA_EXP_3D  # (B, J, 3, S)
    d2 = ((d[..., 0, :] ** 2)[..., :, None, None] + (d[..., 1, :] ** 2)[..., None, :, None]
          + (d[..., 2, :] ** 2)[..., None, None, :])
    g = 255.0 * _exp(-0.5 * d2)
    labeled = (kps_world != 0).any(dim=-1)
    g = torch.where(labeled[..., None, None, None], g, torch.zeros_like(g))
    return torch.movedim(g, 1, -1)


def gaussian_heatmaps_3d(keypoints_vox: np.ndarray, keypoints_world: np.ndarray,
                         size: int) -> np.ndarray:
    """3D Gaussian GT volumes (J, size, size, size) float32 on the host, as
    the JAX package's ``gaussian_heatmaps_3d`` (the reference's
    Dataset3D.__getitem__, jarvis/dataset/dataset3D.py:233-248): peak 255,
    sigma-exponent 1.7, joints with all-zero world coordinates left empty."""
    r = np.arange(size)
    xx, yy, zz = np.meshgrid(r, r, r, indexing="ij")
    J = keypoints_vox.shape[0]
    out = np.zeros((J, size, size, size), dtype=np.float32)
    for i in range(J):
        if not np.any(keypoints_world[i] != 0):
            continue
        kx, ky, kz = keypoints_vox[i]
        out[i] = 255.0 * np.exp(
            -0.5 * (((kx - xx) / SIGMA_EXP_3D) ** 2
                    + ((ky - yy) / SIGMA_EXP_3D) ** 2
                    + ((kz - zz) / SIGMA_EXP_3D) ** 2)
        )
    return out
