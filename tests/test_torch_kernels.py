"""Each kernel's plain PyTorch version (what a CPU tensor runs) against the
JAX function it replaces, on the same seeded inputs.

K1 instance_norm_act   vs models.layers.instance_norm + activation, and
                          vs the Pallas kernel tools/fused_norm_bench.py
                          (interpret mode);
K2 repro_quarter_gather vs models.repro.reprojection_layer('quarter_fused'),
                          indices bit-identical to reproject_indices;
K5 repro_grid_gather    vs reprojection_layer('exact' / 'half' / 'half_fused'),
                          indices bit-identical to reproject_indices;
K3 soft_argmax          vs the epilogue of models/hybridnet.py:95-114;
K4 resize_normalize     vs ops.image resize_bilinear(_mxu) + normalize_imagenet.
The CUDA kernels themselves are checked against these on the card by
chip_smoke.py.
"""

import contextlib
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jarvis_hybridnet_torch import kernels
from jarvis_hybridnet_torch.models.layers import instance_norm as port_instance_norm
from jarvis_hybridnet_torch.models.repro import reprojection_layer as port_repro
from jarvis_hybridnet_torch.testing import synthetic_rig
from jarvis_hybridnet_tpu.models.layers import instance_norm
from jarvis_hybridnet_tpu.models.repro import reproject_indices, reprojection_layer
from jarvis_hybridnet_tpu.ops.image import (
    normalize_imagenet,
    resize_bilinear,
    resize_bilinear_mxu,
)
from jarvis_hybridnet_tpu.utils.reprojection import project_points

REPO = pathlib.Path(__file__).resolve().parents[1]
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def bf16_ulps(got, ref, floor=0.0):
    """|got - ref| in bf16 ulps of |ref| (ulp of max(|ref|, floor))."""
    mag = np.maximum(np.abs(ref).astype(np.float64), max(floor, 1e-30))
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return np.abs(got.astype(np.float64) - ref) / ulp


def _to_bf16_torch(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


# ---------------------------------------------------------------- K1 -------

_JAX_ACTS = {
    "none": lambda y, s: y,
    "silu": lambda y, s: jax.nn.silu(y),
    "relu": lambda y, s: jax.nn.relu(y),
    "add_relu": lambda y, s: jax.nn.relu(y + s),
}


def _k1_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0 + 1.5).astype(np.float32)
    s = rng.standard_normal(shape).astype(np.float32)
    return x, s


@contextlib.contextmanager
def _private_jax_compiles():
    """JAX's persistent compilation cache off: its directory
    (``tests/.xla_cache_cpu``) is shared by the test processes, which
    write and read it at once."""
    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", enabled)


def _k1_jax(x, s, act):
    with _private_jax_compiles():
        return np.asarray(_JAX_ACTS[act](instance_norm(jnp.asarray(x)), jnp.asarray(s)))


def _k1_port(x, s, act):
    n, c = x.shape[0], x.shape[-1]
    got = kernels.instance_norm_act(
        torch.from_numpy(x).reshape(n, -1, c), act,
        torch.from_numpy(s).reshape(n, -1, c) if act == "add_relu" else None)
    return got.reshape(x.shape).numpy()


def _k1_float64(x, s, act):
    """InstanceNorm + act in float64 with numpy: the yardstick that says
    which side moved when the two disagree."""
    x64 = x.astype(np.float64)
    axes = tuple(range(1, x.ndim - 1))
    mean = x64.mean(axis=axes, keepdims=True)
    y = (x64 - mean) / np.sqrt(((x64 - mean) ** 2).mean(axis=axes, keepdims=True) + 1e-5)
    return {"none": y, "silu": y / (1.0 + np.exp(-y)), "relu": np.maximum(y, 0.0),
            "add_relu": np.maximum(y + s, 0.0)}[act]


@pytest.mark.parametrize("act", ["none", "silu", "relu", "add_relu"])
@pytest.mark.parametrize("shape", [(2, 12, 10, 24), (2, 6, 5, 7, 10)])
def test_k1_f32_matches_jax_instance_norm(act, shape):
    """The port's float32 plain version within 1e-5 of JAX's. The JAX side
    compiles outside the persistent cache that the test processes share
    (ROADMAP.md section C: one case failed once in six parallel processes
    and never alone). On a mismatch both sides are computed again and
    each is held to the float64 yardstick, so the failure says which side
    moved and whether it moves again."""
    x, s = _k1_inputs(shape)
    ref, got = _k1_jax(x, s, act), _k1_port(x, s, act)
    if np.abs(got - ref).max() > 1e-5:
        f64 = _k1_float64(x, s, act)
        again_ref, again_got = _k1_jax(x, s, act), _k1_port(x, s, act)
        pytest.fail(
            "port vs JAX {:.3e} at > 1e-5; from float64: port {:.3e} (again {:.3e}), JAX "
            "{:.3e} (again {:.3e}); instances (sample, channel) off by > 1e-5: port {}, JAX {}"
            .format(np.abs(got - ref).max(), np.abs(got - f64).max(),
                    np.abs(again_got - f64).max(), np.abs(ref - f64).max(),
                    np.abs(again_ref - f64).max(), _off_instances(got, f64),
                    _off_instances(ref, f64)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


_K1_FRESH_PROCESS = """
import json, os, sys
import numpy as np, torch, jax, jax.numpy as jnp
sys.path.insert(0, os.getcwd())
from tests.test_torch_kernels import _k1_float64, _k1_inputs, _k1_jax, _k1_port
x, s = _k1_inputs((2, 12, 10, 24))
f64 = _k1_float64(x, s, "silu")
ref = _k1_jax(x, s, "silu")
calls = [_k1_port(x, s, "silu") for _ in range(2)]
print(json.dumps({"threads": torch.get_num_threads(),
                  "to_float64": [float(np.abs(c - f64).max()) for c in calls],
                  "to_jax": [float(np.abs(c - ref).max()) for c in calls]}))
"""


def test_k1_f32_silu_first_calls_in_a_fresh_process():
    """C.4 (ROADMAP.md section C): the case that failed now and then in
    six-process runs, in a process of its own with an xdist worker's
    thread count (torch's default, a thread a core), so that its 5760
    values span several threads: the port's first and second calls are
    each within 1e-5 of float64 and of JAX. The failures were torch's CPU
    float32 ``exp`` (MKL's vector library, a chunk of 2048 values at most a
    thread) computing one thread's chunk at reduced accuracy on the
    process's first call; the plain version now checks its float32
    ``exp`` against float64 and computes an off result again
    (``instance_norm._exp``)."""
    import json
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k not in ("OMP_NUM_THREADS",
                                                              "MKL_NUM_THREADS")}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", _K1_FRESH_PROCESS], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["threads"] >= min(3, os.cpu_count() or 1), got
    assert max(got["to_float64"]) <= 1e-5, got
    assert max(got["to_jax"]) <= 1e-5, got


@pytest.mark.parametrize("faulty_calls", [1, 2])
def test_k1_f32_silu_recomputes_a_reduced_accuracy_exp(faulty_calls, monkeypatch):
    """C.4's fault made on purpose: torch's float32 ``exp`` returns one
    chunk of 1920 values 3e-5 off (as the captured failures read) on its
    first ``faulty_calls`` calls. After one such call the plain SiLU is
    bit-equal to the unfaulted one; after two it raises."""
    from jarvis_hybridnet_torch.kernels import instance_norm as k1

    x, s = _k1_inputs((2, 12, 10, 24))
    want = _k1_port(x, s, "silu")
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
        np.testing.assert_array_equal(_k1_port(x, s, "silu"), want)
    else:
        with pytest.raises(RuntimeError, match="1e-6 from float64"):
            _k1_port(x, s, "silu")
    assert calls["faulty"] == faulty_calls


def _off_instances(a, b):
    axes = tuple(range(1, a.ndim - 1))
    return [tuple(int(i) for i in ix) for ix in np.argwhere(np.abs(a - b).max(axis=axes) > 1e-5)]


def test_k1_f32_matches_pallas_kernel_interpret():
    """The repo's Pallas kernel (InstanceNorm + SiLU), run in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "fused_norm_bench", REPO / "tools" / "fused_norm_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    x, _ = _k1_inputs((2, 16, 16, 16), seed=1)
    ref = np.asarray(bench.instance_norm_silu_fused(jnp.asarray(x), apply_silu=True,
                                                    interpret=True))
    got = kernels.instance_norm_act(torch.from_numpy(x).reshape(2, -1, 16), "silu")
    np.testing.assert_allclose(got.reshape(x.shape).numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("act", ["none", "silu", "relu", "add_relu"])
def test_k1_bf16_within_one_ulp_of_jax(act):
    shape = (2, 9, 11, 20)
    x, s = _k1_inputs(shape, seed=2)
    xb, sb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(s, jnp.bfloat16)
    ref = np.asarray(_JAX_ACTS[act](instance_norm(xb), sb).astype(jnp.float32))
    got = kernels.instance_norm_act(
        _to_bf16_torch(xb.astype(jnp.float32)).reshape(2, -1, 20), act,
        _to_bf16_torch(sb.astype(jnp.float32)).reshape(2, -1, 20)
        if act == "add_relu" else None)
    assert got.dtype == torch.bfloat16
    ulps = bf16_ulps(got.float().reshape(shape).numpy(), ref)
    assert ulps.max() <= 1.0, ulps.max()


def test_k1_layer_wrapper_on_channels_last_tensors():
    """layers.instance_norm takes NCHW / NCDHW channels-last tensors and
    hands K1 their NHWC / NDHWC memory without a copy."""
    x, s = _k1_inputs((2, 6, 5, 7, 10), seed=3)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)  # NCDHW view, channels last
    st = torch.from_numpy(s).permute(0, 4, 1, 2, 3)
    assert xt.is_contiguous(memory_format=torch.channels_last_3d)
    out = port_instance_norm(xt, "add_relu", skip=st)
    assert out.shape == xt.shape
    assert out.is_contiguous(memory_format=torch.channels_last_3d)
    ref = np.asarray(jax.nn.relu(instance_norm(jnp.asarray(x)) + s))
    np.testing.assert_allclose(out.permute(0, 2, 3, 4, 1).numpy(), ref, atol=1e-5)


def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    x = torch.empty((2, 8, 4), device="meta")
    with pytest.raises(ValueError):
        kernels.instance_norm_act(x, "relu")
    with pytest.raises(ValueError):
        kernels.instance_norm_act(torch.zeros(2, 8, 4), "add_relu")  # no skip


# ---------------------------------------------------------------- K2 -------

def _k2_inputs(dtype, seed=0, distort=True):
    rng = np.random.default_rng(seed)
    rig = synthetic_rig(4, 320, 256, seed=seed)
    B, C, J, hs = 2, 4, 5, 66  # bbox 128 -> 64^2 heatmaps padded by 1 px
    heatmaps = (rng.random((B, C, J, hs, hs)) * 255.0).astype(np.float32)
    center3d = rng.integers(-30, 30, (B, 3)).astype(np.int32)
    D = rig.distortions if distort else np.zeros_like(rig.distortions)
    centers = np.stack([np.asarray(project_points(c.astype(np.float32), rig.camera_matrices,
                                                  rig.intrinsics, D))
                        for c in center3d]).astype(np.int32)
    # crops off the cube's center, so voxels clamp to the crop window
    center_hm = centers + rng.integers(-90, 90, (B, C, 2)).astype(np.int32)
    P = np.broadcast_to(rig.camera_matrices, (B, C, 4, 3)).copy()
    K = np.broadcast_to(rig.intrinsics, (B, C, 3, 3)).copy()
    D = np.broadcast_to(D, (B, C, 1, 5)).copy()
    if dtype == "bfloat16":  # both sides gather the same bf16 values
        heatmaps = np.asarray(jnp.asarray(heatmaps, jnp.bfloat16).astype(jnp.float32))
    return heatmaps, center3d, center_hm, P, K, D


def _jax_quarter_indices(center3d, center_hm, P, K, D, G, spacing, hs):
    f = jax.vmap(lambda c3d, chm, p, k, d: reproject_indices(
        c3d, chm, p, k, d, G // 2, spacing * 2.0, hs, upsample=False))
    return np.asarray(f(center3d, center_hm, P, K, D))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_matches_reprojection_layer_quarter_fused(dtype):
    G, spacing = 36, 4.0
    hm, c3d, chm, P, K, D = _k2_inputs(dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = np.asarray(reprojection_layer(jnp.asarray(hm), c3d, chm, P, K, D, G, spacing,
                                        mode="quarter_fused", gather_dtype=jdt))
    ref_idx = _jax_quarter_indices(c3d, chm, P, K, D, G, spacing, hm.shape[-1])

    B, C, J, hs, _ = hm.shape
    rows = torch.from_numpy(np.array(hm)).permute(0, 1, 3, 4, 2).reshape(B, C, hs * hs, J)
    rows = rows.contiguous().to(getattr(torch, dtype))
    t = [torch.from_numpy(a) for a in (c3d, chm, P, K, D)]
    vol, idx = kernels.repro_quarter_gather(rows, *t, G // 4, spacing * 4.0,
                                            return_indices=True)
    assert vol.shape == ref.shape == (B, G // 2, G // 2, G // 2, J)
    np.testing.assert_array_equal(idx.numpy(), ref_idx.reshape(idx.shape))
    assert np.abs(vol.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()

    # the public layer takes the JAX layout and gives the same volume
    via_layer = port_repro(torch.from_numpy(hm).to(getattr(torch, dtype)), *t, G, spacing)
    np.testing.assert_array_equal(via_layer.numpy(), vol.numpy())

    # the fixture reaches the clamp branch: indices on both window edges
    cols, rows_ = ref_idx % hs, ref_idx // hs
    assert ((cols == 0) | (rows_ == 0)).any() and ((cols == hs - 2) | (rows_ == hs - 2)).any()


def test_k2_indices_depend_on_distortion():
    """The rig's k1/k2 move indices: the distortion branch is exercised."""
    G, spacing = 36, 4.0
    a = _k2_inputs("float32", distort=True)
    b = _k2_inputs("float32", distort=False)
    ia = _jax_quarter_indices(*a[1:], G, spacing, a[0].shape[-1])
    ib = _jax_quarter_indices(a[1], a[2], a[3], a[4], b[5], G, spacing, a[0].shape[-1])
    assert (ia != ib).mean() > 0.05


# ---------------------------------------------------------------- K5 -------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["exact", "half", "half_fused"])
def test_k5_matches_reprojection_layer(mode, dtype):
    """Indices bit-identical to reproject_indices (with the trilinear index
    upsample in exact mode), volumes within 1e-5 relative of
    reprojection_layer. JAX gathers float32 in exact mode and the compute
    dtype in the half modes; the port gathers the rows in their own dtype,
    which gives the same values (the bf16 heatmaps widened to float32)."""
    G, spacing = 36, 4.0
    hm, c3d, chm, P, K, D = _k2_inputs(dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = np.asarray(reprojection_layer(jnp.asarray(hm), c3d, chm, P, K, D, G, spacing,
                                        mode=mode,
                                        gather_dtype=None if mode == "exact" else jdt))
    hs = hm.shape[-1]
    ref_idx = np.asarray(jax.vmap(lambda a, b, p, k, d: reproject_indices(
        a, b, p, k, d, G, spacing, hs, upsample=mode == "exact"))(c3d, chm, P, K, D))

    B, C, J = hm.shape[:3]
    rows = torch.from_numpy(np.array(hm)).permute(0, 1, 3, 4, 2).reshape(B, C, hs * hs, J)
    rows = rows.contiguous().to(getattr(torch, dtype))
    t = [torch.from_numpy(a) for a in (c3d, chm, P, K, D)]
    vol, idx = kernels.repro_grid_gather(rows, *t, G, spacing, mode, return_indices=True)
    n = G // 2 if mode == "half_fused" else G
    assert vol.shape == ref.shape == (B, n, n, n, J)
    np.testing.assert_array_equal(idx.numpy(), ref_idx.reshape(idx.shape))
    assert np.abs(vol.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()

    # the public layer takes the JAX layout and gives the same volume
    via_layer = port_repro(torch.from_numpy(hm).to(getattr(torch, dtype)), *t, G, spacing,
                           mode=mode)
    np.testing.assert_array_equal(via_layer.numpy(), vol.numpy())


# ---------------------------------------------------------------- K3 -------

def _jax_epilogue(out, center3d, spacing, cube, ftype=jnp.float32):
    """models/hybridnet.py:95-112 in jnp, computing in ``ftype``."""
    out = jax.nn.softplus(out.astype(ftype))
    B, g, J = out.shape[0], out.shape[1], out.shape[-1]
    coords = jnp.arange(g, dtype=ftype)
    norm = jnp.sum(out, axis=(1, 2, 3))
    x = jnp.einsum("bxyzj,x->bj", out, coords) / norm
    y = jnp.einsum("bxyzj,y->bj", out, coords) / norm
    z = jnp.einsum("bxyzj,z->bj", out, coords) / norm
    points = jnp.stack([x, y, z], axis=-1)
    points3d = (points * spacing * 2.0 - cube / 2.0
                + center3d[:, None, :].astype(ftype))
    maxvals = jnp.max(out.reshape(B, -1, J), axis=1)
    return np.asarray(points3d), np.asarray(jnp.clip(maxvals, max=255.0) / 255.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_matches_jax_epilogue(dtype):
    """Points within 1e-4 mm and confidences within 1e-6 of the JAX epilogue
    evaluated in float64 on the same inputs. Against the float32 JAX run the
    points agree to 5e-4 mm: its einsums' own float32 error is ~2.4e-4 mm
    here (ROADMAP.md section C)."""
    rng = np.random.default_rng(4)
    B, g, J = 2, 18, 23
    vol = (rng.standard_normal((B, g, g, g, J)) * 4.0 - 2.0).astype(np.float32)
    vol[:, 5, 9, 11, 3] = 300.0  # one confidence above the 255 clip
    center3d = rng.integers(-100, 100, (B, 3)).astype(np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    vol = np.asarray(jnp.asarray(vol, jdt).astype(jnp.float32))  # values of the dtype
    ref_p32, ref_c32 = _jax_epilogue(jnp.asarray(vol), center3d, 4, 144)
    with jax.enable_x64(True):
        ref_p, ref_c = _jax_epilogue(jnp.asarray(vol, jnp.float64), center3d, 4, 144,
                                     jnp.float64)
    vt = torch.from_numpy(vol).to(getattr(torch, dtype))
    pts, conf = kernels.soft_argmax(vt, torch.from_numpy(center3d), 4.0, 144.0)
    assert pts.shape == (B, J, 3) and conf.shape == (B, J)
    np.testing.assert_allclose(pts.numpy(), ref_p, rtol=0, atol=1e-4)
    np.testing.assert_allclose(conf.numpy(), ref_c, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pts.numpy(), ref_p32, rtol=0, atol=5e-4)
    np.testing.assert_allclose(conf.numpy(), ref_c32, rtol=0, atol=1e-6)
    assert conf[0, 3] == 1.0


# ---------------------------------------------------------------- K4 -------

def _frames(shape, seed=5):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("src,dst", [((256, 320), (64, 64)), ((90, 100), (37, 41))])
def test_k4_f32_matches_resize_bilinear_and_normalize(src, dst):
    """Production ratios (1024x1280 -> 256^2 is 4 and 5, as 256x320 -> 64^2)
    and a non-integer pair through the general tap tables."""
    x = _frames((3,) + src + (3,))
    ref = np.asarray(normalize_imagenet(resize_bilinear(jnp.asarray(x), *dst) / 255.0,
                                        MEAN, STD))
    got = kernels.resize_normalize(torch.from_numpy(x), *dst, MEAN, STD, torch.float32)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_k4_bf16_rounds_once_and_tracks_resize_bilinear_mxu():
    """K4 computes in f32 and rounds once, so at bf16 it is within half an
    ulp of the exact (f32) resize + normalize. The JAX bf16 path rounds
    after each matmul and elementwise op with bf16 mean/std and is itself up
    to ~3 ulps from exact here, so K4 agrees with it to 3 ulps (ROADMAP.md
    section C). ulps are taken at max(|ref|, 1)."""
    x = _frames((3, 256, 320, 3))
    exact = np.asarray(normalize_imagenet(resize_bilinear(jnp.asarray(x), 64, 64) / 255.0,
                                          MEAN, STD))
    resized = resize_bilinear_mxu(jnp.asarray(x), 64, 64, jnp.bfloat16) / 255.0
    mxu = np.asarray(normalize_imagenet(resized, MEAN.astype(jnp.bfloat16),
                                        STD.astype(jnp.bfloat16)).astype(jnp.float32))
    got = kernels.resize_normalize(torch.from_numpy(x), 64, 64, MEAN, STD, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert bf16_ulps(got, exact, floor=1.0).max() <= 0.5
    assert bf16_ulps(got, mxu, floor=1.0).max() <= 3.0


@pytest.mark.parametrize("frame_type", ["uint8", "float32"])
@pytest.mark.parametrize("src", [(1024, 1280), (256, 320)])
def test_k4_production_ratios_match_jax(src, frame_type):
    """uint8 frames and float32 frames in [0, 1] (value_scale 1, no /255)
    at the production ratios 1280x1024 -> 256^2 (integer: JAX's bf16 path
    resizes by bf16 selection matmuls) and 320x256 -> 256^2 (the two-phase
    low-resolution frames, 1 and 1.25: JAX falls back to the exact resize,
    ``ops/image.py:117-118``). float32: equal to ``resize_bilinear`` +
    normalize to 1e-6 (0 measured on float frames); bf16: within half an
    ulp of that and 3 ulps of JAX's bf16 path (float frames: 3.0 and 2.0
    measured), the bounds of the uint8 tests (ROADMAP.md section C)."""
    x, scale = _frames((2,) + src + (3,)), 255.0
    if frame_type == "float32":
        x, scale = x.astype(np.float32) / 255.0, 1.0
    exact = np.asarray(normalize_imagenet(resize_bilinear(jnp.asarray(x), 256, 256) / scale,
                                          MEAN, STD))
    mxu = np.asarray(normalize_imagenet(
        resize_bilinear_mxu(jnp.asarray(x), 256, 256, jnp.bfloat16) / scale,
        MEAN.astype(jnp.bfloat16), STD.astype(jnp.bfloat16)).astype(jnp.float32))
    got = kernels.resize_normalize(torch.from_numpy(x), 256, 256, MEAN, STD, torch.float32)
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-6)
    got = kernels.resize_normalize(torch.from_numpy(x), 256, 256, MEAN, STD, torch.bfloat16)
    got = got.float().numpy()
    assert bf16_ulps(got, exact, floor=1.0).max() <= 0.5
    assert bf16_ulps(got, mxu, floor=1.0).max() <= 3.0
