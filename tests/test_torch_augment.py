"""K9's plain version (the port's on-device color augmentation) against the
JAX package's ``ops/augment.py``, on the CPU.

- At pinned parameters with ``noise_scale`` 0 (JAX draws its noise with
  threefry, which the port does not reproduce): blur sigma 0, 0.3 and 0.5,
  contrast, gain and per-channel gain, with a rotated ``minv`` for the 2D
  border re-zero, lead rank 1 (2D batches) and 2 (3D batches of cameras):
  the [0, 1] image (K9 with mean 0 and std 1) within 2e-6 of JAX's
  ``make_color_aug`` + ``make_border_zero``, and the normalized image
  within 2e-6 / min(std).
- The noise field: a pure function of the seed (the same seed gives the same
  field, another seed another), ``noise_pc`` 0 gives three equal channels,
  and its mean and standard deviation over a 256^2 x 3 field lie within 4
  standard errors of 0 and 1; the int64 Philox of the plain version against
  Random123's published known-answer vectors.
- Neutral parameters give ``/255`` and normalize alone, bit for bit.
- ``sample_color_params`` equals JAX's for the same numpy seed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jarvis_hybridnet_torch.config.defaults import get_default_cfg
from jarvis_hybridnet_torch.kernels.color_aug import color_aug_plain, noise_field, philox4x32
from jarvis_hybridnet_torch.ops.augment import (
    PARAM_KEYS,
    blur_radius,
    make_border_zero,
    make_color_aug,
    sample_color_params,
)
from jarvis_hybridnet_tpu.config.defaults import get_default_cfg as jax_default_cfg
from jarvis_hybridnet_tpu.ops import augment as jax_augment
from tests.test_torch_models import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
TOL = 2e-6  # on the [0, 1] scale: float32 round-off of the blur sums and taps


@pytest.fixture(scope="module")
def jax_fns():
    """JAX's color augmentation and border re-zero at the default config,
    each jitted once for the module."""
    cfg = jax_default_cfg()
    color = jax.jit(jax_augment.make_color_aug(cfg.AUGMENTATION))
    border = jax.jit(jax_augment.make_border_zero())
    return color, border


def _params(lead, sigma, rng):
    """Pinned parameters: every image blurred at ``sigma`` but the last (the
    delta taps), no noise, drawn gains."""
    n = int(np.prod(lead))
    blur = np.full(n, sigma, np.float32)
    blur[-1] = 0.0
    p = {
        "blur_sigma": blur,
        "noise_scale": np.zeros(n, np.float32),
        "noise_pc": (rng.random(n) < 0.5).astype(np.float32),
        "noise_seed": rng.integers(0, 2**31 - 1, n).astype(np.uint32),
        "contrast": rng.uniform(0.8, 1.2, n).astype(np.float32),
        "mul": rng.uniform(0.8, 1.2, n).astype(np.float32),
        "chan_mul": rng.uniform(0.8, 1.2, (n, 3)).astype(np.float32),
    }
    return {k: v.reshape(lead + v.shape[1:]) for k, v in p.items()}


def _minv(lead, rng):
    n = int(np.prod(lead))
    out = np.zeros((n, 2, 3), np.float32)
    for i in range(n):
        a, s = rng.uniform(-0.6, 0.6), rng.uniform(0.8, 1.2)
        m = np.array([[s * math.cos(a), -s * math.sin(a), 0.0],
                      [s * math.sin(a), s * math.cos(a), 0.0]])
        m[:, 2] = 32.0 - m[:, :2] @ np.array([32.0, 32.0]) + rng.uniform(-4, 4, 2)
        out[i] = m
    return out.reshape(lead + (2, 3))


def _torch(p):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("lead", [(2,), (2, 3)], ids=["rank1", "rank2"])
@pytest.mark.parametrize("sigma", [0.0, 0.3, 0.5])
def test_k9_plain_matches_jax_at_pinned_parameters(jax_fns, lead, sigma):
    color, border = jax_fns
    rng = np.random.default_rng(int(sigma * 10) + len(lead))
    imgs = rng.integers(0, 256, lead + (64, 64, 3), dtype=np.uint8)
    p = _params(lead, sigma, rng)
    minv = _minv(lead, rng) if len(lead) == 1 else None
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ref = color(jnp.asarray(imgs, jnp.float32) / 255.0, jp)
    if minv is not None:
        ref = border(ref, jnp.asarray(minv))
    ref = np.asarray(ref)
    cfg = get_default_cfg()
    radius = blur_radius(cfg.AUGMENTATION)
    assert radius == 2  # max(1, round(4 * 0.5))
    t_minv = None if minv is None else torch.from_numpy(minv)
    unit = color_aug_plain(torch.from_numpy(imgs), _torch(p), (0.0,) * 3, (1.0,) * 3, t_minv,
                           radius, noise=True).numpy()
    assert np.abs(unit - ref).max() <= TOL
    if minv is not None:  # the mask removed something, and the same pixels
        assert (ref == 0).all(axis=-1).any() and np.array_equal(ref == 0, unit == 0)
    apply = make_color_aug(cfg.AUGMENTATION, MEAN, STD)
    normed = apply(torch.from_numpy(imgs), _torch(p), t_minv).numpy()
    ref_n = (ref - np.asarray(MEAN, np.float32)) / np.asarray(STD, np.float32)
    assert np.abs(normed - ref_n).max() <= TOL / min(STD)


def test_border_zero_matches_jax(jax_fns):
    _, border = jax_fns
    rng = np.random.default_rng(5)
    x = rng.random((3, 64, 64, 3)).astype(np.float32)
    minv = _minv((3,), rng)
    ref = np.asarray(border(jnp.asarray(x), jnp.asarray(minv)))
    got = make_border_zero()(torch.from_numpy(x), torch.from_numpy(minv)).numpy()
    assert np.array_equal(got, ref)


def test_neutral_parameters_give_normalize_alone():
    rng = np.random.default_rng(2)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 32, 48, 3), dtype=np.uint8))
    p = {"blur_sigma": np.zeros(2, np.float32), "noise_scale": np.zeros(2, np.float32),
         "noise_pc": np.ones(2, np.float32), "noise_seed": np.array([3, 9], np.uint32),
         "contrast": np.ones(2, np.float32), "mul": np.ones(2, np.float32),
         "chan_mul": np.ones((2, 3), np.float32)}
    ident = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]).expand(2, 2, 3)
    got = color_aug_plain(imgs, _torch(p), MEAN, STD, ident, 2, True)
    assert torch.equal(got, color_aug_plain(imgs, None, MEAN, STD))


def test_noise_field_is_a_function_of_the_seed():
    seeds = torch.tensor([7, 7, 8], dtype=torch.int64)
    field = noise_field(seeds, 256, 256, torch.ones(3))
    assert torch.equal(field[0], field[1]) and not torch.equal(field[0], field[2])
    assert torch.isfinite(field).all()
    flat = field[0].flatten().double()
    n = flat.numel()  # 256^2 x 3
    assert abs(float(flat.mean())) < 4 / math.sqrt(n)
    assert abs(float(flat.std()) - 1.0) < 4 / math.sqrt(2 * n)
    shared = noise_field(seeds[:1], 64, 64, torch.zeros(1))
    assert torch.equal(shared[..., 0], shared[..., 1]) and torch.equal(shared[..., 0],
                                                                       shared[..., 2])
    assert torch.equal(shared[..., 0], noise_field(seeds[:1], 64, 64, torch.ones(1))[..., 0])


def test_philox_matches_random123_known_answers():
    """Philox-4x32-10 of counter 0 under key 0: Random123's kat_vectors give
    (6627e8d5, e169c58d, bc57ac4c, 9b00dbd8) for the all-zero counter and
    key; the int64 arithmetic of the plain version reproduces it."""
    words = philox4x32(torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64))
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_sample_color_params_match_jax():
    cfg, jcfg = get_default_cfg(), jax_default_cfg()
    a = sample_color_params(cfg.AUGMENTATION.COLOR_MANIPULATION, np.random.default_rng(4), 12)
    b = jax_augment.sample_color_params(jcfg.AUGMENTATION.COLOR_MANIPULATION,
                                        np.random.default_rng(4), 12)
    assert tuple(a) == PARAM_KEYS == jax_augment.PARAM_KEYS
    for k in PARAM_KEYS:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
