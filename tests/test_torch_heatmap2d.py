"""K8's and K10's plain versions against the JAX package, on the CPU.

K8 (the 2D training loss with its Gaussian targets):
- the targets of ``ops/heatmap.gaussian_heatmaps_on_device`` against JAX's
  and against the host ``gaussian_heatmaps`` of both packages, at both
  scales and both sigmas (CenterDetect 1.0 * out / 64, KeypointDetect 1.5 *
  out / 64), with keypoints at (0, 0), off the map, on .5 boundaries after
  scaling (where truncation and round-half-to-even decide the centre and the
  window), and at the map's edges: masks and windows identical, values
  within 4e-5 (the peak is 255);
- the loss and both heads' gradients against ``jax.value_and_grad`` of the
  JAX package's ``heatmap_loss`` over its targets: the loss within 1e-6
  relative, each gradient within 1e-6 of its largest element.

K10 (the heatmap argmax): integers and maxima identical to JAX's
``argmax_2d``, on random maps, all-zero maps and plateaus of tied maxima, in
float32 and bfloat16, through a permuted channels-last view as the callers
pass it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jarvis_hybridnet_torch.kernels.heatmap2d_loss import (
    heatmap2d_loss,
    heatmap2d_loss_bwd_plain,
    heatmap2d_loss_fwd_plain,
    sigmas,
)
from jarvis_hybridnet_torch.ops.heatmap import (
    argmax_2d,
    gaussian_heatmaps,
    gaussian_heatmaps_on_device,
)
from jarvis_hybridnet_tpu.ops import heatmap as jax_heatmap
from jarvis_hybridnet_tpu.training.trainer2d import heatmap_loss as jax_heatmap_loss
from tests.test_torch_models import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

S = 64  # input size: heads at 16^2 and 32^2


def _kps(j, seed):
    """(2, j, 2) keypoints at input resolution with the hard cases in the
    first rows: (0, 0), off the map, the edges. At /2 of CenterDetect every
    window corner is a .5 case (3 sigma + 1 = 2.5)."""
    rng = np.random.default_rng(seed)
    k = rng.uniform(0, S, (2, j, 2)).astype(np.float32)
    special = np.array([
        [0.0, 0.0],        # unlabeled
        [-3.0, 20.0],      # off the map
        [S + 1.0, 5.0],    # off the map
        [10.0, 18.0],      # centres 2 / 4 at /4 and 5 / 9 at /2
        [6.0, 14.0],
        [0.25, S - 0.25],  # the edges
        [S - 1.0, 0.5],
        [2.0, 2.0],
    ], np.float32)
    n = min(j, len(special))
    k[0, :n] = special[:n]
    k[1, : min(j, 3)] = special[3:3 + min(j, 3)][::-1]
    return k


@pytest.mark.parametrize("base", [1.0, 1.5], ids=["center", "keypoint"])
@pytest.mark.parametrize("j", [1, 3, 8])
def test_k8_targets_match_jax_and_host(base, j):
    kps = _kps(j, j)
    for out, sigma in zip((S // 4, S // 2), sigmas(base, S)):
        got = gaussian_heatmaps_on_device(torch.from_numpy(kps), S, out, sigma).numpy()
        ref = np.asarray(jax_heatmap.gaussian_heatmaps_on_device(jnp.asarray(kps), S, out,
                                                                 sigma))
        assert got.shape == ref.shape == (2, out, out, j)
        assert np.array_equal(got > 0, ref > 0)  # masks and windows
        assert np.abs(got - ref).max() <= 4e-5
        for b in range(2):
            host = gaussian_heatmaps(kps[b], S, out, sigma)
            assert np.array_equal(host, jax_heatmap.gaussian_heatmaps(kps[b], S, out, sigma))
            assert np.array_equal(got[b].transpose(2, 0, 1) > 0, host > 0)
            assert np.abs(got[b].transpose(2, 0, 1) - host).max() <= 4e-5


def test_k8_half_boundaries_round_half_to_even():
    """CenterDetect's target at /2 of a 64^2 input has sigma 0.5, so the
    window corner c - (3 sigma + 1) = c - 2.5 is always a .5 case: centres 4
    and 5 give corners rint(1.5) = 2 and rint(2.5) = 2 (a cast gives 1 and
    2, roundf 2 and 3). Both packages start both windows at column and row
    2."""
    sigma = sigmas(1.0, S)[1]
    assert 3 * sigma + 1 == 2.5
    kps = np.array([[[8.0, 8.0], [10.0, 11.0]]], np.float32)  # centres 4 and 5 at /2
    got = gaussian_heatmaps_on_device(torch.from_numpy(kps), S, S // 2, sigma).numpy()
    ref = np.asarray(jax_heatmap.gaussian_heatmaps_on_device(jnp.asarray(kps), S, S // 2,
                                                             sigma))
    for j in range(2):
        rows, cols = np.nonzero(got[0, :, :, j])
        assert rows.min() == cols.min() == 2 and cols.max() == 2 + int(6 * sigma + 3) - 1
        assert np.array_equal(got[0, :, :, j] > 0, ref[0, :, :, j] > 0)
    assert np.abs(got - ref).max() <= 4e-5


@pytest.fixture(scope="module")
def jax_loss():
    def f(o4, o2, kps, base):
        t4 = jax_heatmap.gaussian_heatmaps_on_device(kps, S, S // 4, sigmas(base, S)[0])
        t2 = jax_heatmap.gaussian_heatmaps_on_device(kps, S, S // 2, sigmas(base, S)[1])
        return jax_heatmap_loss((o4, o2), (t4, t2))

    return jax.jit(jax.value_and_grad(f, argnums=(0, 1)), static_argnums=3)


@pytest.mark.parametrize("base,j", [(1.0, 1), (1.5, 3)], ids=["center", "keypoint"])
def test_k8_loss_and_gradient_match_jax(jax_loss, base, j):
    rng = np.random.default_rng(j)
    kps = _kps(j, 10 + j)
    o4 = (rng.standard_normal((2, S // 4, S // 4, j)) * 40 + 20).astype(np.float32)
    o2 = (rng.standard_normal((2, S // 2, S // 2, j)) * 40 + 20).astype(np.float32)
    loss, (g4, g2) = jax_loss(jnp.asarray(o4), jnp.asarray(o2), jnp.asarray(kps), base)
    # the port's heads are NCHW tensors in channels-last memory
    t4 = torch.from_numpy(o4).permute(0, 3, 1, 2).requires_grad_()
    t2 = torch.from_numpy(o2).permute(0, 3, 1, 2).requires_grad_()
    got = heatmap2d_loss(t4, t2, torch.from_numpy(kps), S, base)
    got.backward()
    assert abs(float(got) - float(loss)) <= 1e-6 * abs(float(loss))
    for mine, ref in ((t4.grad, g4), (t2.grad, g2)):
        ref = np.asarray(ref)
        assert np.abs(mine.permute(0, 2, 3, 1).numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    # the plain forward's per-scale means and the backward alone
    total, means = heatmap2d_loss_fwd_plain(t4.detach(), t2.detach(), torch.from_numpy(kps), S,
                                            base)
    assert torch.equal(total, got.detach()) and means.shape == (2,)
    d4, _ = heatmap2d_loss_bwd_plain(t4.detach(), t2.detach(), torch.from_numpy(kps), S, base,
                                     torch.tensor(2.0))
    assert torch.allclose(d4, 2 * t4.grad, rtol=0, atol=1e-6 * float(t4.grad.abs().max()))


def _maps(dtype, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((3, 5, 12, 16)).astype(np.float32)  # (N, C, H, W)
    m[0, 0] = 0.0  # all zero: index 0
    m[1, 2] = 1.0
    m[1, 2, 3:5, 7:9] = 9.0  # a plateau: the first in row-major order
    m[2, 4, :, 5] = 7.0  # a column of ties
    m[2, 1, 11, 15] = 50.0  # the last element
    return torch.from_numpy(m).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k10_plain_matches_jax_argmax(dtype):
    maps = _maps(dtype, 3).contiguous(memory_format=torch.channels_last)
    view = maps.permute(0, 2, 3, 1)  # (N, H, W, C), as the callers pass it
    xy, mx = argmax_2d(view)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref_xy, ref_mx = jax_heatmap.argmax_2d(jnp.asarray(view.float().numpy()).astype(jdt))
    assert xy.dtype == torch.int32 and mx.dtype == torch.float32
    assert np.array_equal(xy.numpy(), np.asarray(ref_xy))
    assert np.array_equal(mx.numpy(), np.asarray(ref_mx.astype(jnp.float32)))
    assert xy[0, 0].tolist() == [0, 0] and xy[1, 2].tolist() == [7, 3]
    assert xy[2, 4].tolist() == [5, 0] and xy[2, 1].tolist() == [15, 11]


def test_k10_vector_loads_follow_the_layout():
    """K10 reads 16 bytes at a time wherever its runs start on 16 bytes: the
    single-channel CenterDetect heads and contiguous NCHW maps (a run per
    channel plane) and the channels-last multi-channel heads (a run per
    image), not planes that start off 16 bytes or strided views."""
    from jarvis_hybridnet_torch.kernels.argmax2d import plan_of

    center = torch.zeros(96, 1, 128, 128, dtype=torch.bfloat16)
    assert plan_of(center.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)).vec
    assert plan_of(torch.zeros(8, 23, 128, 128).permute(0, 2, 3, 1)).vec
    keypoint = torch.zeros(4, 23, 128, 128).contiguous(memory_format=torch.channels_last)
    assert plan_of(keypoint.permute(0, 2, 3, 1)).vec
    assert plan_of(torch.zeros(2, 1, 12, 10).permute(0, 2, 3, 1)).vec  # planes of 480 bytes
    assert not plan_of(torch.zeros(2, 1, 5, 5).permute(0, 2, 3, 1)).vec  # of 100 bytes
    assert not plan_of(torch.zeros(2, 1, 12, 20).permute(0, 2, 3, 1)[:, :, ::2]).vec


@pytest.mark.parametrize("n,hw,c", [(4, 128 * 128, 23), (8, 128 * 128, 23), (2, 16 * 16, 3),
                                    (1, 7, 600)])
def test_k10_tile_plan_covers_every_pixel(n, hw, c):
    """The interleaved launch (channels-last heads): blocks of whole warps,
    at most 1024 threads, shares of whole pixels that cover each image's
    pixels once, none empty, each within its shared-memory stage."""
    from jarvis_hybridnet_torch.kernels.argmax2d import _STAGE_BYTES, layout, plan_of

    h = 16 if hw == 256 else 1
    hm = torch.zeros(n, c, h, hw // h).contiguous(memory_format=torch.channels_last)
    hm = hm.permute(0, 2, 3, 1)
    plan = plan_of(hm)
    assert layout(tuple(hm.shape), hm.stride()) == ("interleaved" if c > 1 else "planar")
    assert plan.interleaved and plan.runs == n and plan.cr == c
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.per % c == 0 and plan.per * 4 <= max(_STAGE_BYTES, 4 * c)
    assert (plan.shares - 1) * plan.per < hw * c <= plan.shares * plan.per
