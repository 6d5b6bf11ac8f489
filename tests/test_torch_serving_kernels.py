"""The serving path's head and crops as kernels: K15 ``heatmap_head`` (the
stride-2 heatmap head, torch's ConvTranspose2d k4 s2 p1) and K16
``crop_normalize`` (the crop windows at their centers, normalized), on the
CPU, where each wrapper runs its plain version.

- K15's plain version against the JAX package's ``ConvTranspose2dTorch``
  (``models/layers.py:90-135``), its weight carried across by the port's
  converter (``models/weights.py``), Cin 64 to 1 and 23 channels on 16x16
  and 20x24 maps: float32 within 1e-5 of the output's largest magnitude;
  bf16 within one bf16 ulp of JAX's bf16 run at every element, and each
  within one ulp of the float64 value rounded to bf16 (both round float32
  sums of the same bf16 operands once, in other orders), the share of
  elements that differ at most BF16_SHARE (measured: 0 to 4.9e-4). An ulp is
  that of the element, or of ULP_FLOOR of the output's largest magnitude
  where the element is smaller: where the sum cancels to near zero, the
  float32 sums' own round-off (about 64 terms of 0.1 at 2^-24) exceeds the
  tiny element's ulp, and two orders part by 2 of them (measured once, at
  -5.3e-6 of a range of 1).
- The rows mode (the 3D cascade's padded heatmap rows) equals the head's
  output padded by a zero border and zero spare lanes, bit for bit.
- K16's plain version bit for bit against ``jax.lax.dynamic_slice`` and
  ``normalize_imagenet`` as the JAX cascades use them
  (``predictor3d.py:136-143``), for uint8 and float32 frames, centers
  inside the frame, at both clamp limits and beyond them (where
  ``dynamic_slice`` counts a negative start from the end and clamps it); at
  bf16 the float32 result rounded once; the whole-window mode (phase B's
  host crops).
- EfficientTrack and HybridNet's heatmap rows at no grad (K15) against the
  forward with a graph (the cuDNN chain on the card, the port's code before
  the kernel), and the predictors' crops (K16) against the seed's indexed
  gather and normalize, each call counted.
"""

import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jarvis_hybridnet_torch import kernels
from jarvis_hybridnet_torch.kernels.repro_gather import padded_width
from jarvis_hybridnet_torch.models import layers
from jarvis_hybridnet_torch.models.efficienttrack import EfficientTrackBackbone
from jarvis_hybridnet_torch.models.hybridnet import HybridNetBackbone
from jarvis_hybridnet_torch.models.weights import _kernel, params_from_jax
from jarvis_hybridnet_torch.utils.ckpt_io import read_ckpt
from jarvis_hybridnet_tpu.models.layers import ConvTranspose2dTorch
from jarvis_hybridnet_tpu.ops.image import normalize_imagenet
from tests.test_torch_kernels import bf16_ulps
from tests.test_torch_models import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

k15 = importlib.import_module("jarvis_hybridnet_torch.kernels.heatmap_head")
k16 = importlib.import_module("jarvis_hybridnet_torch.kernels.crop_normalize")

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float32": (torch.float32, jnp.float32)}
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
F32_TOL = 1e-5  # float32 against JAX, of the output's largest magnitude
BF16_SHARE = 1e-3  # bf16: share of elements one ulp from JAX's bf16 run (summation order)
ULP_FLOOR = 2.0 ** -8  # bf16 ulps of at least this share of the output's largest magnitude


def _bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _head_inputs(cout, size, seed, cin=64, n=2):
    """A smooth-ish NHWC map and a JAX ``deconv1`` kernel (4, 4, Cout, Cin)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, *size, cin)) + np.linspace(-1, 1, size[1])[:, None]).astype(
        np.float32)
    k = (rng.standard_normal((4, 4, cout, cin)) / np.sqrt(4 * cin)).astype(np.float32)
    return x, k


def _float64_head(x, k) -> np.ndarray:
    """The head in float64 on the same operands, NHWC, as float32."""
    y = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(np.array(x, np.float64)).permute(0, 3, 1, 2),
        torch.from_numpy(_kernel(k).astype(np.float64)), stride=2, padding=1)
    return y.permute(0, 2, 3, 1).numpy().astype(np.float32)


def _port_head(x, k, tdt, width=0):
    xt = torch.from_numpy(np.array(x)).to(tdt).permute(0, 3, 1, 2)  # channels-last NCHW
    wt = torch.from_numpy(_kernel(k)).to(tdt)
    return kernels.heatmap_head(xt, wt, width)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("size", [(16, 16), (20, 24)])
@pytest.mark.parametrize("cout", [1, 23])
def test_k15_plain_matches_jax(cout, size, dtype):
    tdt, jdt = DTYPES[dtype]
    x, k = _head_inputs(cout, size, seed=cout + size[1])
    if dtype == "bfloat16":
        x, k = _bf16(x), _bf16(k)
    head = ConvTranspose2dTorch(cout, kernel_size=4, stride=2, padding=1, dtype=jdt)
    ref = np.asarray(head.apply({"params": {"kernel": jnp.asarray(k)}}, jnp.asarray(x, jdt)),
                     np.float32)
    got = _port_head(x, k, tdt)
    assert got.dtype == tdt and tuple(got.shape) == (2, cout, 2 * size[0], 2 * size[1])
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.float().permute(0, 2, 3, 1).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL * np.abs(ref).max())
    else:
        floor = ULP_FLOOR * float(np.abs(ref).max())
        exact = _bf16(_float64_head(x, k))
        ulps = bf16_ulps(got, ref, floor)
        assert float(ulps.max()) <= 1.0 and float((got != ref).mean()) <= BF16_SHARE
        assert float(bf16_ulps(got, exact, floor).max()) <= 1.0
        assert float(bf16_ulps(ref, exact, floor).max()) <= 1.0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cout", [1, 23])
def test_k15_rows_mode_is_the_head_padded(cout, dtype):
    """Rows of ``padded_width`` lanes: the head's output at (1, 1), a zero
    border, zero lanes from Cout on; bit for bit."""
    tdt = DTYPES[dtype][0]
    x, k = _head_inputs(cout, (20, 24), seed=5)
    width = padded_width(cout, tdt.itemsize)
    rows = _port_head(x, k, tdt, width)
    hm = _port_head(x, k, tdt)
    assert rows.dtype == tdt and tuple(rows.shape) == (2, 42, 50, width) and rows.is_contiguous()
    want = torch.zeros_like(rows)
    want[:, 1:-1, 1:-1, :cout] = hm.permute(0, 2, 3, 1)
    assert torch.equal(rows, want)


def test_k15_follows_the_weight_strides():
    """A channels-last weight (``layers.cast_convs``) gives the bits of a
    contiguous one."""
    x, k = _head_inputs(23, (16, 16), seed=6)
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    wt = torch.from_numpy(_kernel(k)).to(torch.bfloat16)
    assert torch.equal(kernels.heatmap_head(xt, wt.contiguous(memory_format=torch.channels_last)),
                       kernels.heatmap_head(xt, wt))


# --------------------------------------------------------------- K16 -------

H, W, S = 40, 56, 16


def _frames(kind, n, seed):
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    return u8 if kind == "uint8" else (u8.astype(np.float32) / 255.0)


CENTERS = {
    "inside": [[20, 17], [33, 25], [9, 30]],
    "clamp_limits": [[S // 2, S // 2], [W - S // 2, H - S // 2], [S // 2, H - S // 2]],
    "beyond": [[0, -4], [W + 5, H], [3, 60]],
}


def _jax_crops(frames, centers, size):
    """``predictor3d.py:136-143``: dynamic_slice at (cy - s/2, cx - s/2),
    float32 / value_scale, normalize_imagenet."""
    scale = 255.0 if frames.dtype == np.uint8 else 1.0
    hw = size // 2

    def crop(img, c):
        return jax.lax.dynamic_slice(img, (c[1] - hw, c[0] - hw, 0), (size, size, 3))

    crops = jax.vmap(crop)(jnp.asarray(frames), jnp.asarray(centers, jnp.int32))
    return np.asarray(normalize_imagenet(crops.astype(jnp.float32) / scale, MEAN, STD))


@pytest.mark.parametrize("centers", list(CENTERS))
@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_k16_plain_matches_jax(kind, centers):
    frames = _frames(kind, 3, seed=len(centers))
    c = np.asarray(CENTERS[centers], np.int32)
    ref = _jax_crops(frames, c, S)
    got = kernels.crop_normalize(torch.from_numpy(frames), torch.from_numpy(c), S, MEAN, STD)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), ref)
    bf = kernels.crop_normalize(torch.from_numpy(frames), torch.from_numpy(c), S, MEAN, STD,
                                torch.bfloat16)
    assert torch.equal(bf, got.to(torch.bfloat16))


@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_k16_whole_window(kind):
    """No centers: each frame's window at (0, 0); of S x S frames, the
    whole frame (phase B's host crops), as JAX normalizes them."""
    frames = _frames(kind, 2, seed=3)[:, :S, :S].copy()
    got = kernels.crop_normalize(torch.from_numpy(frames), None, S, MEAN, STD)
    scale = 255.0 if kind == "uint8" else 1.0
    ref = np.asarray(normalize_imagenet(jnp.asarray(frames).astype(jnp.float32) / scale, MEAN,
                                        STD))
    assert np.array_equal(got.numpy(), ref)


def test_k16_divides_as_ieee():
    """Every uint8 value / 255 as float32 division (not a product with the
    reciprocal, which CUDA's division by a CPU scalar takes)."""
    frames = np.arange(256, dtype=np.uint8).repeat(3).reshape(1, 16, 16, 3)
    got = kernels.crop_normalize(torch.from_numpy(frames), None, 16, (0.0,) * 3, (1.0,) * 3)
    want = frames.astype(np.float32) / np.float32(255.0)
    assert np.array_equal(got.numpy(), want)
    # the product with the reciprocal is not the same function
    assert not np.array_equal(frames.astype(np.float32) * (np.float32(1.0) / np.float32(255.0)),
                              want)


# ---------------------------------------------------- serving modules -----

class _Calls:
    """Counts the calls of the K15 / K16 ops."""

    def __init__(self, monkeypatch):
        self.n = {"heatmap_head": 0, "crop_normalize": 0}
        for name, module in (("heatmap_head", k15), ("crop_normalize", k16)):
            monkeypatch.setattr(module, "_op", self._wrap(module._op, name))

    def _wrap(self, op, name):
        def call(*args):
            self.n[name] += 1
            return op(*args)
        return call


def _keypoint_net(tdt):
    model = EfficientTrackBackbone("small", 23)
    model.load_state_dict(params_from_jax(read_ckpt(str(TRAINED / "KeypointDetect_final.ckpt")),
                                          "small"), strict=True)
    return layers.cast_convs(model.eval(), tdt)


def _images(n, size, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n, 3, size, size)).astype(np.float32)
                            ).contiguous(memory_format=torch.channels_last)


def _within_one_ulp(got, want):
    """bf16: at most one ulp apart (float32 sums of the same bf16 operands
    rounded once, in other orders; ulps as in test_k15_plain_matches_jax),
    at most BF16_SHARE of the elements differing; float32: equal."""
    if got.dtype == torch.float32:
        return torch.equal(got, want)
    g, w = got.float().numpy(), want.float().numpy()
    ulps = bf16_ulps(g, w, ULP_FLOOR * float(np.abs(w).max()))
    return float(ulps.max()) <= 1.0 and float((g != w).mean()) <= BF16_SHARE


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_efficienttrack_no_grad_head_equals_the_conv(dtype, monkeypatch):
    """The trained KeypointDetect at 64^2: the no-grad forward's stride-2
    head (K15, one call a forward) against the forward with a graph (the
    convolution that cuDNN runs on the card); the stride-4 head equal."""
    tdt = DTYPES[dtype][0]
    model = _keypoint_net(tdt)
    x = _images(2, 64, seed=20)
    calls = _Calls(monkeypatch)
    with torch.no_grad():
        got4, got2 = model(x)
        alone = model.heatmap2(x)
    assert calls.n["heatmap_head"] == 2
    with torch.enable_grad():
        want4, want2 = model(x)
    assert calls.n["heatmap_head"] == 2  # the chain called no op
    assert torch.equal(got4, want4.detach()) and torch.equal(alone, got2)
    assert got2.dtype == tdt and got2.is_contiguous(memory_format=torch.channels_last)
    assert _within_one_ulp(got2, want2.detach())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_heatmap_rows_no_grad_equals_the_chain(dtype, monkeypatch):
    """HybridNet's heatmap rows: K15's rows mode at no grad against the
    head with a graph, then the zero buffer and the copy (the seed's code),
    padding included."""
    tdt = DTYPES[dtype][0]
    model = HybridNetBackbone(23, "small", 48, 4)
    model.load_state_dict(params_from_jax(read_ckpt(str(TRAINED / "HybridNet_final.ckpt")),
                                          "small"), strict=True)
    layers.cast_convs(model.eval(), tdt)
    imgs = _images(4, 64, seed=21).permute(0, 2, 3, 1).reshape(2, 2, 64, 64, 3)
    calls = _Calls(monkeypatch)
    with torch.no_grad():
        got = model.heatmap_rows(imgs)
    assert calls.n["heatmap_head"] == 1
    with torch.enable_grad():
        for p in model.effTrack.parameters():
            p.requires_grad_(True)
        want = model.heatmap_rows(imgs).detach()
    assert calls.n["heatmap_head"] == 1
    width = padded_width(23, tdt.itemsize)
    assert got.shape == want.shape == (2, 2, 34 * 34, 23) and got.stride() == want.stride()
    assert got.stride()[2] == width
    buf = torch.as_strided(got, (2, 2, 34, 34, width), (2 * 34 * 34 * width,
                                                        34 * 34 * width, 34 * width, width, 1))
    assert not buf[:, :, 0].any() and not buf[:, :, -1].any() and not buf[..., 0, :].any()
    assert not buf[..., -1, :].any() and not buf[..., 23:].any()
    assert _within_one_ulp(got, want)


def _seed_crops(imgs, center_hm, bbox, mean, std):
    """The port's ``Predict3D.crops`` before K16: an indexed gather, then
    the float32 normalize."""
    T, C = imgs.shape[:2]
    hw = bbox // 2
    r = torch.arange(bbox)
    rows = (center_hm[..., 1, None] - hw + r)[..., :, None]
    cols = (center_hm[..., 0, None] - hw + r)[..., None, :]
    t = torch.arange(T)[:, None, None, None]
    c = torch.arange(C)[None, :, None, None]
    crops = imgs[t, c, rows, cols].float() / (255.0 if imgs.dtype == torch.uint8 else 1.0)
    return (crops - torch.tensor(mean)) / torch.tensor(std)


@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_predictor_crops_equal_the_seed(kind, monkeypatch):
    """``Predict3D.crops`` and phase B's ``normalize`` (one K16 call each)
    against the seed's gather and normalize: float32 bit for bit, and the
    compute dtype the float32 crops rounded once."""
    from jarvis_hybridnet_torch.prediction.predictor3d import Predict3D

    pred = Predict3D.__new__(Predict3D)
    pred.bbox, pred.mean, pred.std = S, list(MEAN), list(STD)
    imgs = torch.from_numpy(_frames(kind, 6, seed=7).reshape(2, 3, H, W, 3))
    centers = torch.tensor([[[20, 17], [48, 32], [8, 8]], [[30, 20], [9, 31], [40, 9]]],
                           dtype=torch.int32)
    calls = _Calls(monkeypatch)
    want = _seed_crops(imgs, centers, S, MEAN, STD)
    got = pred.crops(imgs, centers)
    assert got.shape == (2, 3, S, S, 3) and torch.equal(got, want)
    assert torch.equal(pred.crops(imgs, centers, torch.bfloat16), want.to(torch.bfloat16))
    host = imgs[:, :, 4:4 + S, 10:10 + S].contiguous()
    assert torch.equal(pred.normalize(host), _seed_crops(
        host, torch.full((2, 3, 2), S // 2, dtype=torch.int32), S, MEAN, STD))
    assert calls.n["crop_normalize"] == 3
