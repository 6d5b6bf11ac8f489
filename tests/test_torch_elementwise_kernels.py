"""The 2D nets' elementwise chains as kernels: K13 ``weighted_fuse`` (a
BiFPN fusion, EfficientTrack's merge), K14 ``se_gate`` (the SE gate and
SiLU) and K1's ``bias`` operand, on the CPU, where each wrapper runs its
plain version.

- K13's plain version against the JAX package's fusion
  (``models/bifpn.py::_FusionWeights`` and the fusion expressions, with its
  ``upsample_nearest`` / ``max_pool_2x2`` / ``silu``) and merge
  (``models/efficienttrack.py:62-69``), in every operand mode (same, nearest
  x2 and x4, a floor-mode 2x2 max pool of odd sizes), with 2 and 3 inputs
  and weights at or below 0: bf16 within 1 bf16 ulp of JAX's float32 value
  rounded to bf16, float32 within 2e-6 relative (round-off: XLA's exp and
  SiLU are not torch's); and bit for bit the chain the port ran before the
  kernel (the seed's ``bifpn._fuse`` / ``efficienttrack.merged`` code, copied
  below), rounded to the compute dtype where no graph is recorded, float32
  and unrounded where one is.
- K14's plain version against ``jax.nn.sigmoid(g) * x`` and
  ``jax.nn.silu``: bf16 bit for bit, float32 within 2e-6 relative; and bit
  for bit the seed's ``sigmoid(se) * x`` / ``x * sigmoid(x)``.
- K1's plain version with ``bias`` equals ``x + bias`` then the plain K1,
  bit for bit, in both dtypes and every activation; ``layers.conv_norm``
  equals ``instance_norm(conv(...))`` bit for bit at bf16 for each kind of
  biased convolution that an InstanceNorm follows.
- The serving modules (EfficientTrack-small on the trained KeypointDetect
  weights, V2V with its fused front on the trained HybridNet's) at no grad,
  where K13, K14 and K1's bias run, give the outputs of the autograd chains
  (the code before the kernels) bit for bit at bf16 and float32 (the
  stride-2 head: K15 on the same merged map), with 25
  K13, 14 K14 and 31 biased K1 calls a 2D net at bf16 and 11 biased K1
  calls in V2V.
- C.14: a reduced-accuracy float32 ``exp`` on the CPU is computed again in
  ``layers.sigmoid``, as in K1's SiLU (``test_torch_kernels.py``).
- ``torch.library.opcheck`` of the new and changed registered ops' schemas
  and fake implementations on CPU tensors (K15 and K16, the head and the
  crops, among them; ``test_torch_serving_kernels.py`` holds them to JAX).
"""

import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jarvis_hybridnet_torch import kernels
from jarvis_hybridnet_torch.kernels import instance_norm as k1
from jarvis_hybridnet_torch.kernels.soft_argmax import softplus
from jarvis_hybridnet_torch.models import layers
from jarvis_hybridnet_torch.models.efficienttrack import EfficientTrackBackbone
from jarvis_hybridnet_torch.models.v2v import V2VNet
from jarvis_hybridnet_torch.models.weights import params_from_jax
from jarvis_hybridnet_torch.utils.ckpt_io import read_ckpt
from jarvis_hybridnet_tpu.models import bifpn as jax_bifpn
from jarvis_hybridnet_tpu.models import layers as jax_layers
from tests.test_torch_kernels import bf16_ulps
from tests.test_torch_models import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

# the wrappers' modules (the package's names are the wrappers)
k13 = importlib.import_module("jarvis_hybridnet_torch.kernels.weighted_fuse")
k14 = importlib.import_module("jarvis_hybridnet_torch.kernels.se_gate")

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
F32_RTOL = 2e-6  # float32 against JAX: round-off of exp / SiLU, relative to the output's range
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float32": (torch.float32, jnp.float32)}
OPS = torch.ops.jarvis_torch


def _nchw(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """An NHWC numpy array as an NCHW tensor in channels-last memory."""
    return torch.from_numpy(np.array(a, np.float32)).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# --------------------------------------------------------------- K13 -------

# (modes, merge, output (h, w)); sources sized by mode, pool from odd sizes
K13_CASES = {
    "same_up2": (("same", "up2"), False, (6, 4)),
    "same_up4": (("same", "up4"), False, (8, 4)),
    "same_pool_odd": (("same", "pool"), False, (5, 3)),
    "same_same_pool": (("same", "same", "pool"), False, (5, 6)),
    "up2_same_pool": (("up2", "same", "pool"), False, (4, 6)),
    "merge": (("same", "up2", "up4"), True, (8, 12)),
}


def _k13_inputs(modes, size, seed, c=16, n=2):
    """NHWC numpy inputs giving an (h, w) output in each mode; a pooled
    input is one pixel larger than twice the output where the output is odd
    (floor mode drops it)."""
    rng = np.random.default_rng(seed)
    h, w = size
    dims = {"same": (h, w), "up2": (h // 2, w // 2), "up4": (h // 4, w // 4),
            "pool": (2 * h + h % 2, 2 * w + w % 2)}
    return [(rng.standard_normal((n, *dims[m], c)) * 2).astype(np.float32) for m in modes]


def _k13_weights(kind, count):
    if kind == "positive":
        return np.array([0.7, 1.3, 0.4][:count], np.float32)
    return np.array([-0.5, 0.0, 1.3][:count], np.float32)  # at and below 0


def _jax_in_mode(x, mode):
    if mode == "pool":
        return jax_layers.max_pool_2x2(x)
    if mode == "same":
        return x
    return jax_layers.upsample_nearest(x, 2 if mode == "up2" else 4)


def _jax_fuse(w, xs, modes, merge):
    """The JAX package's fusion (``_FusionWeights`` and ``silu(w0 x0 + w1 x1
    [+ w2 x2])``) or merge (softplus weights, no SiLU): float32."""
    if merge:
        wn = jnp.logaddexp(w, 0.0)
        wn = wn / (jnp.sum(wn) + 1e-4)
    else:
        wn = jax_bifpn._FusionWeights(len(xs)).apply({"params": {"w": jnp.asarray(w)}})
    out = wn[0] * _jax_in_mode(xs[0], modes[0])
    for i in range(1, len(xs)):
        out = out + wn[i] * _jax_in_mode(xs[i], modes[i])
    return np.asarray(out if merge else jax_layers.silu(out))


def _seed_fuse(w, xs, modes, merge):
    """The port's fusion before K13 (the seed's ``bifpn._fuse`` and
    ``efficienttrack.merged``, with ``layers.upsample_nearest`` /
    ``max_pool_2x2`` / ``silu`` as they were): float32."""
    def up(x, f):
        if torch.is_grad_enabled() and x.requires_grad:
            n, c, h, wd = x.shape
            return x[:, :, :, None, :, None].expand(n, c, h, f, wd, f).reshape(n, c, h * f, wd * f)
        return x.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)

    xs = [F.max_pool2d(x, 2, 2) if m == "pool" else up(x, 2) if m == "up2"
          else up(x, 4) if m == "up4" else x for x, m in zip(xs, modes)]
    if merge:
        wn = softplus(w)
        wn = wn / (wn.sum() + 1e-4)
        return (wn[0] * xs[0].float() + wn[1] * xs[1].float() + wn[2] * xs[2].float())
    wn = torch.clamp_min(w, 0.0)
    wn = wn / (wn.sum() + 1e-4)
    out = wn[0] * xs[0].float()
    for i in range(1, len(xs)):
        out = out + wn[i] * xs[i].float()
    return out * (1.0 / (1.0 + torch.exp(-out)))


@pytest.mark.parametrize("weights", ["positive", "nonpositive"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(K13_CASES))
def test_k13_plain_matches_jax(case, dtype, weights):
    modes, merge, size = K13_CASES[case]
    tdt, jdt = DTYPES[dtype]
    xs = [_bf16(a) if dtype == "bfloat16" else a for a in _k13_inputs(modes, size, len(case))]
    w = _k13_weights(weights, len(modes))
    ref = _jax_fuse(w, [jnp.asarray(a, jdt) for a in xs], modes, merge)
    with torch.no_grad():
        got = kernels.weighted_fuse(torch.from_numpy(w), [_nchw(a, tdt) for a in xs], modes, merge)
    assert got.dtype == tdt and got.shape[2:] == size
    assert got.is_contiguous(memory_format=torch.channels_last)
    if dtype == "bfloat16":
        assert float(bf16_ulps(_nhwc(got), _bf16(ref)).max()) <= 1.0
    else:
        np.testing.assert_allclose(_nhwc(got), ref, rtol=0, atol=F32_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(K13_CASES))
def test_k13_equals_the_seed_chain(case, dtype):
    """No graph: the op's result is the seed chain rounded to the compute
    dtype, bit for bit; with one (a weight or an input that requires grad):
    the seed chain's float32 value and a gradient for every operand."""
    modes, merge, size = K13_CASES[case]
    tdt = DTYPES[dtype][0]
    xs = [_nchw(a, tdt) for a in _k13_inputs(modes, size, 3)]
    w = torch.from_numpy(_k13_weights("nonpositive", len(modes)) + 0.9)
    with torch.no_grad():
        want = _seed_fuse(w, xs, modes, merge)
        got = kernels.weighted_fuse(w, xs, modes, merge)
    assert torch.equal(got, want.to(tdt))
    wg = w.clone().requires_grad_()
    xg = [x.clone().requires_grad_() for x in xs]
    got = kernels.weighted_fuse(wg, xg, modes, merge)
    assert got.dtype == torch.float32 and torch.equal(got, _seed_fuse(w, xs, modes, merge))
    got.sum().backward()
    assert wg.grad is not None and all(x.grad is not None for x in xg)


def test_k13_refuses_what_it_cannot_fuse():
    x = torch.zeros(1, 8, 4, 4)
    with pytest.raises(ValueError, match="2 or 3 inputs"):
        kernels.weighted_fuse(torch.ones(1), [x], ("same",))
    with pytest.raises(ValueError, match="unknown modes"):
        kernels.weighted_fuse(torch.ones(2), [x, x], ("same", "up3"))


# --------------------------------------------------------------- K14 -------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k14_plain_matches_jax(dtype):
    """The gate (a (N, C) gate over an (N, C, H, W) map) and SiLU
    (``se_gate(r, r)`` on (N, C, 1, 1))."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 7, 5, 40)) * 2).astype(np.float32)
    g = (rng.standard_normal((3, 1, 1, 40)) * 3).astype(np.float32)
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    for got_fn, ref in ((lambda: kernels.se_gate(_nchw(np.asarray(jx.astype(jnp.float32)), tdt),
                                                 _nchw(np.asarray(jg.astype(jnp.float32)), tdt)),
                         jax.nn.sigmoid(jg) * jx),
                        (lambda: kernels.se_gate(_nchw(np.asarray(jg.astype(jnp.float32)), tdt),
                                                 _nchw(np.asarray(jg.astype(jnp.float32)), tdt)),
                         jax_layers.silu(jg))):
        with torch.no_grad():
            got = got_fn()
        assert got.dtype == tdt
        ref = np.asarray(ref.astype(jnp.float32))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(_nhwc(got), ref)
        else:
            np.testing.assert_allclose(_nhwc(got), ref, rtol=0,
                                       atol=F32_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k14_equals_the_seed_chain(dtype):
    """``sigmoid(se) * x`` and ``x * sigmoid(x)`` as the port ran them
    before K14, bit for bit, with x's strides; with a graph the chain."""
    tdt = DTYPES[dtype][0]
    rng = np.random.default_rng(6)
    x = _nchw((rng.standard_normal((2, 6, 6, 24)) * 2).astype(np.float32), tdt)
    g = torch.from_numpy((rng.standard_normal((2, 24, 1, 1)) * 3).astype(np.float32)).to(tdt)

    def seed_sigmoid(t):
        return 1.0 / (1.0 + torch.exp(-t))

    with torch.no_grad():
        gate, act = kernels.se_gate(x, g), layers.silu(g)
    assert torch.equal(gate, seed_sigmoid(g) * x) and gate.stride() == x.stride()
    assert torch.equal(act, g * seed_sigmoid(g))
    xg = x.clone().requires_grad_()
    out = kernels.se_gate(xg, g)
    assert out.grad_fn is not None and torch.equal(out, seed_sigmoid(g) * x)


@pytest.mark.parametrize("faulty_calls", [1, 2])
def test_c14_sigmoid_recomputes_a_reduced_accuracy_exp(faulty_calls, monkeypatch):
    """C.4's fault made on purpose in ``layers.sigmoid`` (so in SiLU, the
    SE gates and K13's and K14's plain versions): torch's float32 ``exp``
    returns one chunk of 1920 values 3e-5 off on its first ``faulty_calls``
    calls. After one such call the result is bit-equal to the unfaulted
    one; after two it raises."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(6000).astype(np.float32) * 4)
    want = layers.sigmoid(x)
    real_exp, calls = torch.exp, {"faulty": 0}

    def exp(t):
        out = real_exp(t)
        if t.dtype == torch.float32 and calls["faulty"] < faulty_calls:
            calls["faulty"] += 1
            out = out.clone()
            out.view(-1)[1920:3840] *= 1.0 + 3e-5
        return out

    monkeypatch.setattr(k1.torch, "exp", exp)
    if faulty_calls == 1:
        assert torch.equal(layers.sigmoid(x), want)
    else:
        with pytest.raises(RuntimeError, match="1e-6 from float64"):
            layers.sigmoid(x)
    assert calls["faulty"] == faulty_calls


# ------------------------------------------------------------ K1 + bias ----

@pytest.mark.parametrize("act", list(k1.ACTS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k1_bias_equals_the_add_then_k1(dtype, act):
    tdt = DTYPES[dtype][0]
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 30, 24)).astype(np.float32) * 3).to(tdt)
    b = torch.from_numpy(rng.standard_normal(24).astype(np.float32)).to(tdt)
    skip = torch.randn(2, 30, 24).to(tdt) if act == "add_relu" else None
    want = kernels.instance_norm_act_plain(x + b, act, skip)
    assert torch.equal(kernels.instance_norm_act_plain(x, act, skip, b), want)
    got, stats = kernels.instance_norm_act(x, act, skip, return_stats=True, bias=b)
    assert torch.equal(got, want)
    assert torch.equal(stats, k1.stats_plain(x + b))


@pytest.mark.parametrize("kind", ["conv2d_1x1", "conv3d", "conv_transpose3d"])
def test_conv_norm_equals_conv_then_norm_bf16(kind):
    """The pointwise conv of ``SeparableConvBlock`` / ``_DownChannel``, a
    Res3D conv and the decoder's k2 s2 deconv, at bf16 with no graph: the
    bias left to K1 gives ``instance_norm(conv(m, x))``'s bits."""
    torch.manual_seed(9)
    m, shape, act = {
        "conv2d_1x1": (torch.nn.Conv2d(12, 16, 1), (2, 12, 6, 5), "silu"),
        "conv3d": (torch.nn.Conv3d(6, 8, 3, 1, 1), (2, 6, 5, 5, 5), "relu"),
        "conv_transpose3d": (torch.nn.ConvTranspose3d(8, 6, 2, 2), (2, 8, 3, 3, 3), "relu"),
    }[kind]
    with torch.no_grad():
        m.bias.mul_(4.0)
    layers.cast_convs(m, torch.bfloat16)
    fmt = torch.channels_last if len(shape) == 4 else torch.channels_last_3d
    x = torch.randn(shape).to(torch.bfloat16).contiguous(memory_format=fmt)
    with torch.no_grad():
        want = layers.instance_norm(layers.conv(m, x), act)
        assert torch.equal(layers.conv_norm(m, x, act), want)


# ------------------------------------------------------ serving modules ----

class _Counts:
    """Counts the calls of the K13 / K14 ops and of K1 with a bias."""

    def __init__(self, monkeypatch):
        self.n = {"weighted_fuse": 0, "se_gate": 0, "k1_bias": 0}
        for name, module in (("weighted_fuse", k13), ("se_gate", k14)):
            monkeypatch.setattr(module, "_op", self._wrap(module._op, name))
        k1_op = layers.instance_norm_act

        def k1_rec(x, act="none", skip=None, return_stats=False, bias=None):
            self.n["k1_bias"] += bias is not None
            return k1_op(x, act, skip, return_stats, bias=bias)

        monkeypatch.setattr(layers, "instance_norm_act", k1_rec)

    def _wrap(self, op, name):
        def call(*args):
            self.n[name] += 1
            return op(*args)
        return call


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_efficienttrack_no_grad_equals_the_chains(dtype, monkeypatch):
    """EfficientTrack-small, the trained KeypointDetect, 64^2 (P7 at 1^2):
    the no-grad forward (K13, K14, K1's bias) equals the forward with a
    graph (the autograd chains, the port's code before the kernels) bit for
    bit, both heads."""
    tdt = DTYPES[dtype][0]
    model = EfficientTrackBackbone("small", 23)
    model.load_state_dict(params_from_jax(read_ckpt(str(TRAINED / "KeypointDetect_final.ckpt")),
                                          "small"), strict=True)
    layers.cast_convs(model.eval(), tdt)
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64, 64)).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    counts = _Counts(monkeypatch)
    with torch.no_grad():
        got = model(x)
    assert counts.n == {"weighted_fuse": 25, "se_gate": 14,
                        "k1_bias": 31 if dtype == "bfloat16" else 0}
    with torch.no_grad():
        got_merged = model.merged(x)
    with torch.enable_grad():
        want = model(x)
        want_merged = model.merged(x).detach()
    assert counts.n["weighted_fuse"] == 50  # the chains called no op
    assert torch.equal(got_merged, want_merged) and torch.equal(got[0], want[0].detach())
    # the stride-2 head: K15 at no grad (test_torch_serving_kernels.py holds
    # it to the convolution with a graph), on the same merged map
    head = kernels.heatmap_head_plain(want_merged, model.deconv1.weight.detach())
    assert got[1].dtype == want[1].dtype and torch.equal(got[1], head)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_v2v_no_grad_equals_the_chains(dtype, monkeypatch):
    """V2V of the trained HybridNet with its fused front, on an 8^3 half
    grid: no grad (every biased conv's add in K1) against the forward with
    a graph, bit for bit."""
    tdt = DTYPES[dtype][0]
    tree = read_ckpt(str(TRAINED / "HybridNet_final.ckpt"))
    j = 23
    v2v = V2VNet(j, fused_upsample_front=True)
    v2v.load_state_dict({k[len("v2vNet."):]: v for k, v in params_from_jax(tree, "small").items()
                         if k.startswith("v2vNet.")}, strict=True)
    layers.cast_convs(v2v.eval(), tdt)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.random((1, j, 8, 8, 8)).astype(np.float32) * 50).to(tdt)
    x = x.contiguous(memory_format=torch.channels_last_3d)
    counts = _Counts(monkeypatch)
    with torch.no_grad():
        got = v2v(x)
    # the fused front adds its bias in K1 at both dtypes; the others below float32
    assert counts.n["k1_bias"] == (11 if dtype == "bfloat16" else 1)
    with torch.enable_grad():
        want = v2v(x)
    assert torch.equal(got, want.detach())


# --------------------------------------------------------------- opcheck ---

def _op_cases():
    g = torch.Generator().manual_seed(12)

    def cl(*shape):
        return torch.randn(*shape, generator=g).contiguous(memory_format=torch.channels_last)

    a, up2, up4, pool = cl(2, 16, 4, 4), cl(2, 16, 2, 2), cl(2, 16, 1, 1), cl(2, 16, 9, 9)
    w2, w3 = torch.tensor([0.7, -0.2]), torch.tensor([0.3, 1.1, 0.5])
    x, gate, r = cl(2, 24, 5, 5), torch.randn(2, 24, 1, 1, generator=g), torch.randn(2, 6, 1, 1)
    k1x, bias = torch.randn(2, 50, 8, generator=g), torch.randn(8, generator=g)
    one, pool3 = cl(2, 16, 1, 1), cl(2, 16, 3, 3)  # a one-pixel output (floor-mode pool)
    r_cl = torch.empty_strided((2, 6, 1, 1), (6, 1, 6, 6)).copy_(r)  # as a 1x1 conv leaves it
    cases = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        a_, up2_, up4_, pool_ = (t.to(dt) for t in (a, up2, up4, pool))
        cases[f"k13_up2_{name}"] = (OPS.weighted_fuse, (w2, a_, up2_, None, [0, 1], False))
        cases[f"k13_pool_{name}"] = (OPS.weighted_fuse, (w3, a_, a_, pool_, [0, 0, 3], False))
        cases[f"k13_merge_{name}"] = (OPS.weighted_fuse, (w3, a_, up2_, up4_, [0, 1, 2], True))
        cases[f"k14_gate_{name}"] = (OPS.se_gate, (x.to(dt), gate.to(dt)))
        cases[f"k13_one_pixel_{name}"] = (OPS.weighted_fuse, (w2, one.to(dt), pool3.to(dt), None,
                                                              [0, 3], False))
        cases[f"k14_silu_{name}"] = (OPS.se_gate, (r.to(dt), r.to(dt)))
        cases[f"k14_silu_strided_{name}"] = (OPS.se_gate, (r_cl.to(dt), r_cl.to(dt)))
        cases[f"k1_bias_{name}"] = (OPS.instance_norm_act,
                                    (k1x.to(dt), "silu", None, True, bias.to(dt)))
        for cout in (1, 23):  # K15: a one-channel and a keypoint head, plain and as rows
            head = (cl(2, 16, 5, 7).to(dt), torch.randn(16, cout, 4, 4, generator=g).to(dt))
            cases[f"k15_c{cout}_{name}"] = (OPS.heatmap_head, (*head, 0))
            cases[f"k15_c{cout}_rows_{name}"] = (OPS.heatmap_head, (*head, 24))
    frames = torch.randint(0, 256, (3, 20, 30, 3), dtype=torch.uint8, generator=g)
    centers = torch.tensor([[5, 5], [29, 0], [15, 10]], dtype=torch.int32)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    for name, f in (("uint8", frames), ("float32", frames.float() / 255)):
        cases[f"k16_{name}_bf16"] = (OPS.crop_normalize, (f, centers, 8, mean, std,
                                                         torch.bfloat16))
        cases[f"k16_{name}_whole"] = (OPS.crop_normalize, (f[:, :8, :8].contiguous(), None, 8,
                                                          mean, std, torch.float32))
    return cases


CASES = _op_cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_new_registered_ops_schema_and_fake(name):
    """The op runs its plain version (K13: rounded to the inputs' dtype, in
    channels-last memory, contiguous at one pixel; K14: the strides torch
    gives ``sigmoid(g) * x``; K15: channels-last, or contiguous rows; K16:
    contiguous (N, S, S, 3)) and passes opcheck's schema and fake-tensor
    checks (the fake's strides the real output's)."""
    op, args = CASES[name]
    got = op(*args)
    if name.startswith("k13"):
        xs = [t for t in args[1:4] if t is not None]
        modes = [{v: k for k, v in k13.MODES.items()}[m] for m in args[4]]
        want = _seed_fuse(args[0], xs, modes, args[5]).to(xs[0].dtype)
        assert got.is_contiguous(memory_format=torch.channels_last) and torch.equal(got, want)
    elif name.startswith("k14"):
        want = k14.se_gate_plain(*args)
        assert got.stride() == want.stride() and torch.equal(got, want)
    elif name.startswith("k15"):
        want = kernels.heatmap_head_plain(*args)
        assert got.stride() == want.stride() and torch.equal(got, want)
    elif name.startswith("k16"):
        want = kernels.crop_normalize_plain(*args)
        assert got.is_contiguous() and torch.equal(got, want)
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))
