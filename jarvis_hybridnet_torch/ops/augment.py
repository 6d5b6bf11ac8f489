"""On-device training-time color augmentation (port of
``jarvis_hybridnet_tpu/ops/augment.py``).

The host samples only the per-image parameters (:func:`sample_color_params`,
a copy of the JAX package's, drawing the same numbers from the same
generator); the pixel work runs on the device in K9
(``kernels/color_aug.py``), which also divides by 255, re-zeroes the warp's
border (2D) and normalizes, in one launch. :func:`make_color_aug` bakes the
config's static structure (which components apply, the blur's radius) into
that call; :func:`make_border_zero` is the border re-zero alone, on float
images, as K9's plain version applies it.

The op order is the JAX package's (blur, noise, contrast, gain, per-channel
gain, one clip); the blur is ``cv2.GaussianBlur(ksize=(0, 0))``'s:
separable taps truncated at radius round(4 sigma_max), BORDER_REFLECT_101
edges. The noise is not JAX's threefry draw but a Philox field keyed by the
same per-image ``noise_seed`` (``kernels/color_aug.noise_field``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.color_aug import PARAM_KEYS, border_mask, color_aug

__all__ = ["PARAM_KEYS", "blur_radius", "make_border_zero", "make_color_aug", "record_arrays",
           "record_of", "sample_color_params"]


def sample_color_params(cm_cfg, rng, n: int) -> dict:
    """Draw per-image color-aug parameters for ``n`` images on the host, in
    the JAX package's draw order (``ops/augment.py:40``). ``rng`` is the
    dataset's augmentation stream; inactive components get their neutral
    value (sigma 0, gain 1)."""
    def span(r):
        return float(r[0]), float(r[1])

    blo, bhi = span(cm_cfg.GAUSSIAN_BLUR.SIGMA)
    blur_on = rng.random(n) < float(cm_cfg.GAUSSIAN_BLUR.PROBABILITY)
    blur_sigma = np.where(blur_on, rng.uniform(blo, bhi, n), 0.0)

    nlo, nhi = span(cm_cfg.GAUSSIAN_NOISE.SCALE)
    noise_scale = rng.uniform(nlo, nhi, n)
    noise_pc = (rng.random(n)
                < float(cm_cfg.GAUSSIAN_NOISE.PER_CHANNEL_PROBABILITY))
    noise_seed = rng.integers(0, 2**31 - 1, n).astype(np.uint32)

    clo, chi = span(cm_cfg.LINEAR_CONTRAST.SCALE)
    con_on = rng.random(n) < float(cm_cfg.LINEAR_CONTRAST.PROBABILITY)
    contrast = np.where(con_on, rng.uniform(clo, chi, n), 1.0)

    mlo, mhi = span(cm_cfg.MULTIPLY.SCALE)
    mul_on = rng.random(n) < float(cm_cfg.MULTIPLY.PROBABILITY)
    mul = np.where(mul_on, rng.uniform(mlo, mhi, n), 1.0)

    pcm = cm_cfg.PER_CHANNEL_MULTIPLY
    plo, phi = span(pcm.SCALE)
    pcm_on = rng.random(n) < float(pcm.PROBABILITY)
    pcm_pc = rng.random(n) < float(pcm.PER_CHANNEL_PROBABILITY)
    f3 = rng.uniform(plo, phi, (n, 3))
    f1 = rng.uniform(plo, phi, (n, 1))
    chan_mul = np.where(pcm_on[:, None],
                        np.where(pcm_pc[:, None], f3, f1), 1.0)

    return {
        "blur_sigma": blur_sigma.astype(np.float32),
        "noise_scale": noise_scale.astype(np.float32),
        "noise_pc": noise_pc.astype(np.float32),
        "noise_seed": noise_seed,
        "contrast": contrast.astype(np.float32),
        "mul": mul.astype(np.float32),
        "chan_mul": chan_mul.astype(np.float32),
    }


def record_arrays(rec: dict) -> dict:
    """A (collated) color record as the host arrays a train step uploads:
    ``aug.<key>`` for each of ``PARAM_KEYS`` (float32; the seeds int32, as
    K9 reads them)."""
    return {"aug." + k: np.asarray(rec[k], np.int32 if k == "noise_seed" else np.float32)
            for k in PARAM_KEYS}


def record_of(batch: dict) -> dict | None:
    """The color record of an uploaded batch (``record_arrays``' keys), or
    None when the batch carries none."""
    if "aug.mul" not in batch:
        return None
    return {k: batch["aug." + k] for k in PARAM_KEYS}


def blur_radius(aug_cfg) -> int:
    """The blur's tap radius, max(1, round(4 sigma_max)), or 0 where the
    config applies no blur (the JAX package's ``use_blur``)."""
    cm = aug_cfg.COLOR_MANIPULATION
    sig_hi = float(cm.GAUSSIAN_BLUR.SIGMA[1])
    if not (bool(cm.ENABLED) and float(cm.GAUSSIAN_BLUR.PROBABILITY) > 0.0 and sig_hi > 1e-3):
        return 0
    return max(1, int(round(4.0 * sig_hi)))


def make_color_aug(aug_cfg, mean, std):
    """The device color augmentation of the config, normalize included:
    ``apply(imgs, p, minv=None)`` takes raw uint8 images ``lead + (H, W, 3)``
    (``lead`` of rank 1 or 2), the record of :func:`sample_color_params`
    with the same lead shape (or None: ``/255`` and normalize alone) and, for
    the 2D border re-zero, the warp's inverse maps ``lead + (2, 3)``; it
    returns the normalized float32 images through K9."""
    cm = aug_cfg.COLOR_MANIPULATION
    enabled = bool(cm.ENABLED)
    radius = blur_radius(aug_cfg)
    use_noise = enabled and float(cm.GAUSSIAN_NOISE.SCALE[1]) > 0.0

    def apply(imgs: torch.Tensor, p: dict | None, minv: torch.Tensor | None = None):
        if p is None or not enabled:
            return color_aug(imgs, None, mean, std, minv)
        return color_aug(imgs, p, mean, std, minv, radius, use_noise)

    return apply


def make_border_zero():
    """The warp-border re-zero alone: ``apply(x, minv)`` zeroes every pixel of
    float images ``x`` (lead + (H, W, 3)) whose inverse-mapped source center
    (``minv``, lead + (2, 3), dst -> src) falls outside the frame, as the JAX
    package's ``make_border_zero``. K9 applies the same mask in its launch."""
    def apply(x: torch.Tensor, minv: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-3], x.shape[-2]
        inside = border_mask(h, w, minv).reshape(x.shape[:-1])
        return torch.where(inside[..., None], x, torch.zeros_like(x))

    return apply
