"""Serving steps replayed from captured CUDA graphs (``prediction/export.py``).

On the CPU ``wrap_predictor`` calls the step as it is. The capture logic is
held here with ``torch.cuda``'s graph and stream calls replaced by a
stand-in whose graph records, at capture, a call that recomputes the
step's outputs into the same tensors from the same static inputs (what a
replay does on the card). The graphed predictors against the JAX package's
jitted ones use the setup of ``test_torch_predictor3d.py`` (the committed
MonkeyHand checkpoints, 4 synthetic cameras, T = 2 seeded uint8 frames of
256x320, float32) at its bounds (ROADMAP.md section C: points 2e-2 mm,
confidences 1e-4). The card's test (marked ``cuda``) holds replays to the
eager step bit for bit; ``chip_smoke.py`` does so at full size on every
serving path.
"""

import contextlib
import csv
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jarvis_hybridnet_torch.prediction import export
from jarvis_hybridnet_torch.prediction.export import GraphedStep, wrap_predictor
from jarvis_hybridnet_torch.prediction.loaders import make_predictor3d, make_predictor3d_twophase
from jarvis_hybridnet_torch.prediction.predict3d import stream_predict3d
from jarvis_hybridnet_torch.testing import monkeyhand_cfg, synthetic_rig
from jarvis_hybridnet_tpu.config import get_default_cfg
from jarvis_hybridnet_tpu.prediction.loaders import make_predictor3d as jax_make_predictor3d
from jarvis_hybridnet_tpu.prediction.loaders import (
    make_predictor3d_twophase as jax_make_twophase,
)
from tests.test_torch_models import few_torch_threads  # noqa: F401

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
CENTER = str(TRAINED / "CenterDetect_final.ckpt")
HYBRID = str(TRAINED / "HybridNet_final.ckpt")
T, C, H, W, F_LOW = 2, 4, 256, 320, 4
POOL = ("pool", 7)


# ------------------------------------------------------------ stand-in ---

class StandInGraph:
    """What ``torch.cuda.CUDAGraph`` keeps of a capture: the recorded
    calls, each rewriting its outputs in place from its inputs."""

    def __init__(self, fake):
        self.calls = []
        fake.graphs.append(self)

    def replay(self):
        for call in self.calls:
            call()


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda``'s graph, pool, stream and synchronize calls replaced
    by stand-ins; ``fake.graphs`` lists the graphs made, ``fake.pools`` the
    pool of each capture, ``fake.capturing`` the graph being captured."""
    fake = types.SimpleNamespace(graphs=[], pools=[], capturing=None)

    @contextlib.contextmanager
    def graph(g, pool=None):
        fake.pools.append(pool)
        fake.capturing = g
        try:
            yield
        finally:
            fake.capturing = None

    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: StandInGraph(fake))
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: POOL)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    return fake


def recorded(fake, fn, log=None):
    """``fn`` as a capture sees it: a call under capture adds to the graph
    a call that recomputes ``fn`` on the same input tensors into the same
    output tensors. ``log`` collects ("eager" | "capture") per call."""

    def call(*args):
        out = fn(*args)
        if log is not None:
            log.append("capture" if fake.capturing is not None else "eager")
        if fake.capturing is not None:
            def again():
                for o, n in zip(_flat(out), _flat(fn(*args))):
                    o.copy_(n)
            fake.capturing.calls.append(again)
        return out

    return call


def _flat(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def _step_fn(x, y):
    return (x * 2.0 + y.sum(), (x - 1.0).amax(dim=-1))


def _graphed(fake, fn=_step_fn, log=None):
    step = GraphedStep(recorded(fake, fn, log), "cpu", pool=POOL)
    step.graphed = True  # the CUDA branch, on the stand-in
    return step


def _inputs(seed, shape=(3, 5)):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(4).astype(np.float32)))


# -------------------------------------------------------------- tests ---

def test_wrap_predictor_on_the_cpu_calls_the_step(monkeypatch):
    """On a CPU device the wrapper returns the step's outputs bit for bit
    and captures nothing."""
    def refuse(*args, **kwargs):
        raise AssertionError("no capture on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    step = wrap_predictor(_step_fn, "cpu")
    assert not step.graphed and step.pool is None
    for seed in (0, 1):
        x, y = _inputs(seed)
        got, ref = step(x, y), _step_fn(x, y)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert step.graphs == {} and step.captures == {}


def test_one_capture_per_input_key(fake_cuda):
    """A key is (shapes, dtypes): each new one warms up WARMUP times
    eagerly, is captured once and replayed; a known key only replays."""
    log = []
    step = _graphed(fake_cuda, log=log)
    calls = [_inputs(0), _inputs(1), _inputs(2, (2, 5)), _inputs(3), _inputs(4, (2, 5))]
    for x, y in calls:
        got = step(x, y)
        assert all(torch.equal(g, r) for g, r in zip(got, _step_fn(x, y)))
    assert len(fake_cuda.graphs) == 2 and len(step.graphs) == 2
    assert log == (["eager"] * export.WARMUP + ["capture"]) * 2
    assert set(step.captures) == {(((3, 5), torch.float32), ((4,), torch.float32)),
                                  (((2, 5), torch.float32), ((4,), torch.float32))}
    step(_inputs(5)[0].double(), _inputs(5)[1])  # another dtype is another key
    assert len(fake_cuda.graphs) == 3


def test_inputs_are_copied_into_the_static_buffers(fake_cuda):
    """A later call copies its tensors into the buffers the graph was
    captured on; the caller's tensors are never captured."""
    step = _graphed(fake_cuda)
    first, second = _inputs(0), _inputs(1)
    step(*first)
    (_, static, _), = step.graphs.values()
    assert all(s.data_ptr() != a.data_ptr() for s, a in zip(static, first))
    got = step(*second)
    assert all(torch.equal(s, a) for s, a in zip(static, second))
    assert all(torch.equal(g, r) for g, r in zip(got, _step_fn(*second)))


def test_outputs_are_clones(fake_cuda):
    """A second call's replay rewrites the graph's outputs; the first
    call's tensors keep their values."""
    step = _graphed(fake_cuda)
    first, second = _inputs(0), _inputs(1)
    out1 = step(*first)
    kept = [o.clone() for o in out1]
    out2 = step(*second)
    (_, _, static_out), = step.graphs.values()
    for o in out1 + out2:
        assert all(o.data_ptr() != s.data_ptr() for s in static_out)
    assert all(torch.equal(o, k) for o, k in zip(out1, kept))
    assert all(torch.equal(o, r) for o, r in zip(out2, _step_fn(*second)))
    assert not torch.equal(out1[0], out2[0])


def test_graphs_share_one_pool(fake_cuda):
    """Every capture of a wrapper uses its pool; a step given another's
    pool captures into that one."""
    step = _graphed(fake_cuda)
    step(*_inputs(0))
    step(*_inputs(1, (2, 5)))
    other = GraphedStep(recorded(fake_cuda, _step_fn), "cpu", pool=step.pool)
    other.graphed = True
    other(*_inputs(2))
    assert fake_cuda.pools == [POOL] * 3
    assert wrap_predictor(_step_fn, "cpu", pool=POOL).pool is POOL


def test_a_graphed_step_takes_tensors_on_its_device(fake_cuda):
    step = _graphed(fake_cuda)
    with pytest.raises(TypeError, match="takes tensors"):
        step(np.zeros((3, 5), np.float32), _inputs(0)[1])


def test_stream_predict3d_rows_come_from_their_batch(fake_cuda, tmp_path):
    """The driver keeps batch k's outputs while it dispatches batch k + 1.
    With a graphed step on two alternating batches, each batch's CSV rows
    are that batch's outputs (without the clones, every row would be the
    last replay's)."""
    def fn(imgs):
        level = imgs.float().mean(dim=(1, 2, 3, 4))  # (T,)
        points = level[:, None, None] + torch.arange(23 * 3, dtype=torch.float32).reshape(23, 3)
        return points, torch.sigmoid(points[..., 0]), level > 0

    step = _graphed(fake_cuda, fn)
    batches = [np.full((T, C, 4, 6, 3), v, np.uint8) for v in (10, 200)]

    class Reader:
        number_frames = 4 * T

        def __iter__(self):
            for i in range(4):
                yield batches[i % 2], T

        def recycle(self, batch):
            pass

    cfg = monkeyhand_cfg(num_cameras=C)
    cfg.KEYPOINT_NAMES = [f"joint_{j}" for j in range(23)]
    path = stream_predict3d(cfg, _Predictor(step), Reader(), str(tmp_path))
    with open(path, newline="") as f:
        rows = np.array(list(csv.reader(f))[2:], dtype=np.float64)
    assert rows.shape == (4 * T, 23 * 4)
    for k in range(4):
        points, conf, _ = fn(torch.from_numpy(batches[k % 2]))
        ref = torch.cat([points, conf[..., None]], dim=-1).reshape(T, -1).double().numpy()
        np.testing.assert_array_equal(rows[k * T:(k + 1) * T], ref)
    assert len(fake_cuda.graphs) == 1


class _Predictor:
    """A predictor's interface as the driver uses it: ``device`` and a call
    on the uploaded frames."""

    def __init__(self, step):
        self.device = torch.device("cpu")
        self.step = step

    def __call__(self, imgs):
        return self.step(imgs)


# ----------------------------------------- the graphed predictors vs JAX ---

@pytest.fixture(scope="module")
def setup(few_torch_threads):  # noqa: F811
    cfg = monkeyhand_cfg(center_size=64, bbox=128, cube=144, spacing=4, num_cameras=C)
    jcfg = get_default_cfg()
    jcfg.merge_from_other_cfg(cfg)
    rig = synthetic_rig(C, W, H)
    rng = np.random.default_rng(7)
    low = torch.from_numpy(rng.random((T * C, 3, 16, 20)).astype(np.float32))
    smooth = F.interpolate(low, size=(H, W), mode="bilinear", align_corners=False)
    frames = smooth.permute(0, 2, 3, 1).numpy() * 255 + rng.normal(0, 6, (T * C, H, W, 3))
    frames = np.clip(frames, 0, 255).astype(np.uint8).reshape(T, C, H, W, 3)
    return cfg, jcfg, rig, frames


def test_graphed_predictor3d_matches_jax(setup):
    """``make_predictor3d(graph=True)`` on the CPU (the step as it is)
    against JAX's jitted ``build_predict3d``: the gate identical, points to
    2e-2 mm, confidences to 1e-4."""
    cfg, jcfg, rig, frames = setup
    ref_p, ref_c, ref_v = (np.asarray(a) for a in jax_make_predictor3d(
        jcfg, rig, CENTER, HYBRID, dtype=jnp.float32)(frames))
    predictor = make_predictor3d(cfg, rig, CENTER, HYBRID, dtype="float32", device="cpu",
                                 graph=True)
    assert isinstance(predictor.step, GraphedStep)
    points, conf, valid = predictor(frames)
    np.testing.assert_array_equal(valid.numpy(), ref_v)
    np.testing.assert_allclose(points.numpy(), ref_p, rtol=0, atol=2e-2)
    np.testing.assert_allclose(conf.numpy(), ref_c, rtol=0, atol=1e-4)
    eager = make_predictor3d(cfg, rig, CENTER, HYBRID, dtype="float32", device="cpu",
                             graph=False)
    assert eager.step == eager.eager_step
    assert all(torch.equal(a, b) for a, b in zip(eager(frames), (points, conf, valid)))


def test_graphed_twophase_matches_jax(setup):
    """``make_predictor3d_twophase(graph=True)`` on the CPU against JAX's
    ``build_predict3d_twophase``: phase A's centers and gate identical,
    phase B's points to 2e-2 mm and confidences to 1e-4."""
    cfg, jcfg, rig, frames = setup
    blocks = frames.reshape(T, C, H // F_LOW, F_LOW, W // F_LOW, F_LOW, 3).astype(np.float64)
    lowres = np.rint(blocks.mean(axis=(3, 5))).astype(np.uint8)
    ja, jb, jcrop = jax_make_twophase(jcfg, rig, (W, H), CENTER, HYBRID, lowres_factor=F_LOW,
                                      dtype=jnp.float32)
    phase_a, phase_b, crop_fn = make_predictor3d_twophase(
        cfg, rig, (W, H), CENTER, HYBRID, lowres_factor=F_LOW, dtype="float32", device="cpu",
        graph=True)
    assert isinstance(phase_a.step, GraphedStep) and isinstance(phase_b.step, GraphedStep)
    assert phase_b.step.pool is phase_a.step.pool
    ref_a = [np.asarray(a) for a in ja(lowres)]
    got_a = phase_a(lowres)
    for name, g, r in zip(("cx", "cy", "center3d", "valid"), got_a, ref_a):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    cx, cy, c3d, _ = ref_a
    crops = jcrop(frames, cx, cy)
    ref_p, ref_c = (np.asarray(a) for a in jb(crops, cx, cy, c3d))
    got_p, got_c = phase_b(crop_fn(frames, got_a[0].numpy(), got_a[1].numpy()), *got_a[:3])
    np.testing.assert_allclose(got_p.numpy(), ref_p, rtol=0, atol=2e-2)
    np.testing.assert_allclose(got_c.numpy(), ref_c, rtol=0, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py holds every serving path's replays "
                    "to its eager step at full size)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replay_is_bit_equal_to_the_eager_step_on_the_card(setup, cuda_device):
    """On the card, the graphed predictor's replays on two alternating
    batches equal the eager predictor's outputs bit for bit, and the two
    batches' replays differ."""
    cfg, _, rig, frames = setup
    batches = [torch.from_numpy(frames).to(cuda_device),
               torch.from_numpy(frames[::-1].copy()).to(cuda_device)]
    eager, graphed = (make_predictor3d(cfg, rig, CENTER, HYBRID, dtype="float32",
                                       device=cuda_device, graph=g) for g in (False, True))
    outs = {}
    for i in range(4):
        got, ref = graphed(batches[i % 2]), eager(batches[i % 2])
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        outs[i % 2] = got
    assert not all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
    assert len(graphed.step.graphs) == 1
