"""The training path's kernels and stochastic layers on the CPU, against
the JAX package.

K6 ``instance_norm_act_backward``: its plain version against ``jax.vjp`` of
the JAX ``instance_norm`` and the activation after it, for each activation;
the autograd Function ``InstanceNormAct`` (K1 forward, K6 backward) against
autograd through K1's plain version. K7 ``hybridnet_loss``: its plain loss
and gradient against ``jax.value_and_grad`` of ``hybridnet_mse_loss`` on the
double softplus with ``gaussian_heatmaps_3d_on_device`` as the target, with
labeled, unlabeled and all-invalid joints; the 3D targets against JAX's.
The fused up-front conv's weight gradient against JAX's through
``fused_up_conv3d``. Dropout and drop-connect with injected masks against
the masked references, and their keep rate by a moment test.

The kernels themselves are held to these plain versions on the card by
``chip_smoke.py``; the CUDA checks here need the card and skip without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jarvis_hybridnet_torch import kernels
from jarvis_hybridnet_torch.kernels.hybridnet_loss import loss_plan
from jarvis_hybridnet_torch.kernels.instance_norm import InstanceNormAct, backward_plan
from jarvis_hybridnet_torch.models import layers
from jarvis_hybridnet_torch.models.efficientnet import EfficientNetFeatures
from jarvis_hybridnet_torch.models.v2v import Basic3DBlock, V2VNet
from jarvis_hybridnet_torch.ops import fused_upfront as port_fused
from jarvis_hybridnet_torch.ops.heatmap import (
    gaussian_heatmaps_3d,
    gaussian_heatmaps_3d_on_device,
)
from jarvis_hybridnet_tpu.models.hybridnet import hybridnet_mse_loss
from jarvis_hybridnet_tpu.models.layers import drop_connect as jax_drop_connect
from jarvis_hybridnet_tpu.models.layers import instance_norm as jax_instance_norm
from jarvis_hybridnet_tpu.ops import heatmap as jax_heatmap
from jarvis_hybridnet_tpu.ops.fused_upfront import fused_up_conv3d as jax_fused_up_conv3d

ACTS = ["none", "silu", "relu", "add_relu"]
_JAX_ACTS = {
    "none": lambda y, s: y,
    "silu": lambda y, s: jax.nn.silu(y),
    "relu": lambda y, s: jax.nn.relu(y),
    "add_relu": lambda y, s: jax.nn.relu(y + s),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py holds the kernels on the card)")
    return torch.device("cuda")


def _norm_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 + 0.7).astype(np.float32)
    skip = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, skip, dy


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", [(2, 300, 12), (1, 216, 46), (3, 7, 5)])
def test_k6_plain_matches_jax_vjp(act, shape):
    """float32 round-off: the two packages sum S terms in other orders; dx
    held within 2e-6 of max|dx|, dskip (a masked copy of dy) exactly."""
    n, s, c = shape
    x, skip, dy = _norm_inputs(shape, seed=11)

    def f(xx, ss):
        return _JAX_ACTS[act](jax_instance_norm(xx), ss)

    x4, s4 = jnp.asarray(x.reshape(n, s, 1, c)), jnp.asarray(skip.reshape(n, s, 1, c))
    _, vjp = jax.vjp(f, x4, s4)
    jdx, jds = (np.asarray(a).reshape(shape) for a in vjp(jnp.asarray(dy.reshape(n, s, 1, c))))
    xt, st, dyt = (torch.from_numpy(a) for a in (x, skip, dy))
    out = kernels.instance_norm_act_plain(xt, act, st if act == "add_relu" else None)
    dx, dskip = kernels.instance_norm_act_backward_plain(xt, dyt, out, act)
    assert np.abs(dx.numpy() - jdx).max() <= 2e-6 * np.abs(jdx).max()
    if act == "add_relu":
        np.testing.assert_array_equal(dskip.numpy(), jds)
    else:
        assert dskip is None


@pytest.mark.parametrize("act", ACTS)
def test_instance_norm_function_matches_autograd_of_plain(act):
    """The Function's backward (K6's plain version on the CPU) against
    autograd through K1's plain version: float32 round-off, 1e-6 of max."""
    x, skip, dy = _norm_inputs((2, 64, 10), seed=3)
    grads = []
    for use_fn in (True, False):
        xt = torch.from_numpy(x).requires_grad_()
        st = torch.from_numpy(skip).requires_grad_() if act == "add_relu" else None
        y = (InstanceNormAct.apply(xt, st, act) if use_fn
             else kernels.instance_norm_act_plain(xt, act, st))
        inputs = [xt] + ([st] if st is not None else [])
        grads.append(torch.autograd.grad(y, inputs, torch.from_numpy(dy)))
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_instance_norm_layer_uses_the_function_only_with_grad():
    """``layers.instance_norm`` builds a graph through InstanceNormAct when
    an input requires grad and grad is enabled; the inference call has none."""
    def graph_names(fn, seen=None):
        seen = set() if seen is None else seen
        if fn is not None and fn not in seen:
            seen.add(fn)
            for nxt, _ in fn.next_functions:
                graph_names(nxt, seen)
        return {type(f).__name__ for f in seen}

    x = torch.randn(2, 6, 4, 4, 4)
    assert layers.instance_norm(x, "relu").grad_fn is None
    xg = x.clone().requires_grad_()
    assert "InstanceNormActBackward" in graph_names(layers.instance_norm(xg, "relu").grad_fn)
    with torch.no_grad():
        assert layers.instance_norm(xg, "relu").grad_fn is None


@pytest.mark.parametrize("n,s,c", [(1, 46656, 46), (1, 5832, 92), (8, 46656, 46), (96, 16, 56),
                                   (4, 1, 16), (3, 7, 5)])
def test_k6_backward_plan_covers_every_row(n, s, c):
    chunk, nchunk = backward_plan(n, s, c)
    lanes = max(1, 256 // c)
    assert chunk >= min(lanes, s) and nchunk == -(-s // chunk)
    assert (nchunk - 1) * chunk < s <= nchunk * chunk  # every chunk has rows
    assert n * nchunk <= 2 * 264  # about two blocks per SM of an H100


def _loss_inputs(seed, B=2, g=8, J=6):
    """out (B, g, g, g, J); joints: labeled inside the grid, one unlabeled
    (all-zero kp_world row), one labeled far outside the grid (target sum ~0,
    far below the > 1 edge: invalid)."""
    rng = np.random.default_rng(seed)
    out = (rng.standard_normal((B, g, g, g, J)) * 3.0).astype(np.float32)
    kp_vox = rng.uniform(1.5, g - 2.5, (B, J, 3)).astype(np.float32)
    kp_world = rng.uniform(-50, 50, (B, J, 3)).astype(np.float32)
    kp_world[0, 1] = 0.0  # unlabeled
    kp_vox[1, 2] = [-30.0, 40.0, -25.0]  # labeled, target sum ~0: invalid
    return out, kp_vox, kp_world


def test_3d_target_matches_jax():
    """The 3D target and its host version against the JAX package's:
    float32 exp round-off (1e-4 of the 255 peak)."""
    _, kp_vox, kp_world = _loss_inputs(seed=5)
    ref = np.asarray(jax_heatmap.gaussian_heatmaps_3d_on_device(
        jnp.asarray(kp_vox), jnp.asarray(kp_world), 8))
    got = gaussian_heatmaps_3d_on_device(torch.from_numpy(kp_vox), torch.from_numpy(kp_world),
                                         8).numpy()
    assert got.shape == ref.shape == (2, 8, 8, 8, 6)
    assert np.abs(got - ref).max() <= 1e-4
    host = gaussian_heatmaps_3d(kp_vox[0], kp_world[0], 8)
    np.testing.assert_array_equal(host, jax_heatmap.gaussian_heatmaps_3d(kp_vox[0], kp_world[0], 8))


def test_k7_plain_matches_jax_value_and_grad():
    """Loss within 1e-5 relative and dL/dout within 1e-5 of its max (float32
    round-off of the 512-voxel means and of exp / log1p), the valid mask
    equal: labeled joints valid, the unlabeled and the far one not."""
    out, kp_vox, kp_world = _loss_inputs(seed=7)
    g = out.shape[1]

    def jloss(o):
        sp2 = jax.nn.softplus(jax.nn.softplus(o))
        gt = jax_heatmap.gaussian_heatmaps_3d_on_device(jnp.asarray(kp_vox),
                                                        jnp.asarray(kp_world), g)
        return hybridnet_mse_loss(sp2, gt)

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(out))
    ot, kv, kw = (torch.from_numpy(a) for a in (out, kp_vox, kp_world))
    loss, valid, vol = kernels.hybridnet_loss_fwd_plain(ot, kv, kw, return_volume=True)
    expect = np.ones((2, 6), np.float32)
    expect[0, 1] = expect[1, 2] = 0.0
    np.testing.assert_array_equal(valid.numpy(), expect)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    grad = kernels.hybridnet_loss_bwd_plain(ot, kv, kw, valid, torch.tensor(1.0)).numpy()
    assert np.abs(grad - np.asarray(jg)).max() <= 1e-5 * np.abs(np.asarray(jg)).max()
    assert not grad[0, ..., 1].any() and not grad[1, ..., 2].any()
    ref_vol = np.asarray(jax.nn.softplus(jax.nn.softplus(jnp.asarray(out))))
    assert np.abs(vol.numpy() - ref_vol).max() <= 1e-6 * np.abs(ref_vol).max()


def test_k7_all_joints_invalid_gives_zero_loss_and_gradient():
    out, kp_vox, kp_world = _loss_inputs(seed=9)
    kp_world[:] = 0.0
    ot = torch.from_numpy(out).requires_grad_()
    loss = kernels.hybridnet_loss(ot, torch.from_numpy(kp_vox), torch.from_numpy(kp_world))
    loss.backward()
    assert float(loss.detach()) == 0.0 and not ot.grad.any()


def test_k7_function_matches_autograd_of_plain():
    """The autograd Function (K7's plain forward and backward on the CPU)
    against autograd through the plain forward: 1e-6 of max."""
    out, kp_vox, kp_world = _loss_inputs(seed=13)
    kv, kw = torch.from_numpy(kp_vox), torch.from_numpy(kp_world)
    a = torch.from_numpy(out).requires_grad_()
    loss, vol = kernels.hybridnet_loss(a, kv, kw, return_volume=True)
    loss.backward()
    assert not vol.requires_grad
    b = torch.from_numpy(out).requires_grad_()
    ref = kernels.hybridnet_loss_fwd_plain(b, kv, kw)[0]
    ref.backward()
    assert float(loss) == float(ref)
    assert float((a.grad - b.grad).abs().max()) <= 1e-6 * float(b.grad.abs().max())


def test_k7_loss_plan():
    threads, per_block, nblk = loss_plan(36, 23)
    assert threads % 23 == 0 and threads <= 256
    assert (nblk - 1) * per_block < 36 ** 3 <= nblk * per_block


def test_fused_upfront_weight_gradient_matches_jax():
    """The weight gradient through ``prepare_fused_weights`` and
    ``fused_up_conv3d`` against ``jax.vjp`` of the JAX package's
    ``fused_up_conv3d`` (``tests/test_fused_upfront.py:38`` pins JAX's):
    float32 round-off of sums over the volume, 1e-5 of max."""
    rng = np.random.default_rng(17)
    B, L, cin, cout = 2, 5, 3, 4
    x = rng.standard_normal((B, L, L, L, cin)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    dy = rng.standard_normal((B, L, L, L, cout)).astype(np.float32)
    _, vjp = jax.vjp(lambda xx, k, b: jax_fused_up_conv3d(xx, k, b),
                     jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    jdx, jdk, jdb = (np.asarray(a) for a in vjp(jnp.asarray(dy)))
    w = torch.from_numpy(kernel.transpose(4, 3, 0, 1, 2).copy()).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    xt = torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()).requires_grad_()
    interior, corr = port_fused.prepare_fused_weights(w, torch.float32)
    y = port_fused.fused_up_conv3d(xt, interior, corr, b)
    y.backward(torch.from_numpy(dy.transpose(0, 4, 1, 2, 3).copy()))
    dk = w.grad.numpy().transpose(2, 3, 4, 1, 0)
    assert np.abs(dk - jdk).max() <= 1e-5 * np.abs(jdk).max()
    assert np.abs(b.grad.numpy() - jdb).max() <= 1e-5 * np.abs(jdb).max()
    dx = xt.grad.numpy().transpose(0, 2, 3, 4, 1)
    assert np.abs(dx - jdx).max() <= 1e-5 * np.abs(jdx).max()


def test_basic3d_block_fused_weights_follow_the_live_weight():
    """With grad enabled the front conv's weight gets a gradient (no cached
    graph); under no_grad the transform is cached until the weight changes."""
    block = Basic3DBlock(3, 4, 3, 2, fused_up=True).eval()
    x = torch.randn(1, 3, 4, 4, 4)
    block(x).sum().backward()
    assert block.block[0].weight.grad is not None and block.block[0].weight.grad.abs().sum() > 0
    with torch.no_grad():
        y0 = block(x)
        cached = block._fused
        assert torch.equal(block(x), y0) and block._fused is cached
        block.block[0].weight.mul_(2.0)
        assert not torch.equal(block(x), y0) and block._fused is not cached


def test_dropout_with_injected_mask_matches_masked_reference():
    """flax ``nn.Dropout(0.2)``: kept elements scaled by 1 / 0.8, the others
    zero; exact."""
    rng = np.random.default_rng(19)
    x = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    mask = rng.random(x.shape) < 0.8
    got = layers.dropout(torch.from_numpy(x), 0.2, None, torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.where(mask, x / np.float32(0.8), 0.0))


def test_drop_connect_with_injected_uniform_matches_jax():
    """The JAX package's ``drop_connect`` with its own key, against the
    port's with the same key's uniform draws injected: exact."""
    x = np.random.default_rng(23).standard_normal((6, 4, 5, 5)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jax_drop_connect(jnp.asarray(x.transpose(0, 2, 3, 1)), 0.15, False, key))
    u = np.array(jax.random.uniform(key, (6, 1, 1, 1), dtype=jnp.float32)).reshape(6)
    got = layers.drop_connect(torch.from_numpy(x), 0.15, None, torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 1), ref)
    assert {0.0} < set(np.unique((got != 0).any(axis=(1, 2, 3)))) | {0.0}


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_dropout_and_drop_connect_keep_rate(rate):
    """Moment test: the kept fraction of masks drawn from a generator is
    1 - rate within 5 standard deviations; the mean is preserved."""
    g = torch.Generator().manual_seed(1)
    x = torch.ones(200_000)
    y = layers.dropout(x, rate, g)
    kept = float((y != 0).float().mean())
    sd = (rate * (1 - rate) / x.numel()) ** 0.5
    assert abs(kept - (1 - rate)) <= 5 * sd
    assert abs(float(y.mean()) - 1.0) <= 5 * sd / (1 - rate)
    z = layers.drop_connect(torch.ones(20_000, 1, 1, 1), rate, g)
    kept = float((z != 0).float().mean())
    sd = (rate * (1 - rate) / 20_000) ** 0.5
    assert abs(kept - (1 - rate)) <= 5 * sd


def test_stochastic_layers_are_inert_in_eval_and_drawn_in_train():
    torch.manual_seed(0)
    v2v = V2VNet(3).eval()
    x = torch.randn(1, 3, 8, 8, 8)
    g = torch.Generator().manual_seed(5)
    layers.set_generator(v2v, g)
    with torch.no_grad():
        ref = v2v(x)
        assert torch.equal(v2v(x), ref)
        v2v.train()
        a = v2v(x)
        g.manual_seed(5)
        assert torch.equal(v2v(x), a) and not torch.equal(a, ref)
    net = EfficientNetFeatures(0)
    rates = [b.drop_rate for b in net.model._blocks]
    n = len(rates)
    assert rates == [0.2 * i / n for i in range(n)]


@pytest.mark.cuda
def test_k6_and_k7_launch_on_the_card(cuda_device):
    """The kernels against their plain versions on the card (as chip_smoke.py
    checks them at the training step's shapes)."""
    x, skip, dy = (torch.from_numpy(a).to(cuda_device) for a in _norm_inputs((2, 300, 12), 2))
    for act in ACTS:
        out = kernels.instance_norm_act(x, act, skip if act == "add_relu" else None)
        k = kernels.instance_norm_act_backward(x, dy, out, act)
        p = kernels.instance_norm_act_backward_plain(x, dy, out, act)
        assert float((k[0] - p[0]).abs().max()) <= 1e-5 * float(p[0].abs().max())
    out, kv, kw = (torch.from_numpy(a).to(cuda_device) for a in _loss_inputs(seed=3))
    kl, kvalid, _ = kernels.hybridnet_loss_fwd(out, kv, kw)
    pl, pvalid, _ = kernels.hybridnet_loss_fwd_plain(out, kv, kw)
    assert torch.equal(kvalid, pvalid) and abs(float(kl) - float(pl)) <= 1e-5 * float(pl)
