"""Train and eval steps replayed from captured CUDA graphs
(``training/graphed.py``), on the CPU.

On the CPU the trainers run the step as it is. The capture logic is held
here on the stand-in of ``test_torch_graphs.py`` (``torch.cuda``'s graph,
pool, stream and synchronize calls replaced), with what a train step adds:
a capture on the card runs nothing, so the stand-in's capture runs the step
and then puts back what it changed (the trained parameters, the
optimizer's state and the registered generators); its graph records a call
that runs the step again on the static batch into the same output tensors,
as a replay does. Sizes: 4 cameras of 320x256 JPEG, 128^2 crops, a 48 mm
cube at 4 mm (G = 12), 23 joints, batch 1-2 (3D); 64^2 inputs, batch 2
(2D). The graphed steps against the JAX package's jitted ones hold the
bounds of ``test_torch_training.py::test_training_step_matches_jax`` and
``test_torch_training2d.py::test_train_step_matches_jax`` (ROADMAP.md C).
The card's test (marked ``cuda``) holds replays to the eager steps;
``chip_smoke.py`` does so at full size on every training path.
"""

import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jarvis_hybridnet_torch.config.project_manager import ProjectManager
from jarvis_hybridnet_torch.dataset.dataset2d import Dataset2D
from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
from jarvis_hybridnet_torch.models.efficienttrack import EfficientTrackBackbone
from jarvis_hybridnet_torch.models.v2v import set_fused_cache
from jarvis_hybridnet_torch.models.weights import efficienttrack_params_to_jax
from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d, write_project
from jarvis_hybridnet_torch.training import checkpoints, graphed, optim
from jarvis_hybridnet_torch.training.train_interface import train_efficienttrack, train_hybridnet
from jarvis_hybridnet_torch.training.trainer2d import EfficientTrackTrainer, host_batch
from jarvis_hybridnet_torch.training.trainer3d import BATCH_KEYS, HybridNetTrainer
from jarvis_hybridnet_torch.utils import preemption
from jarvis_hybridnet_torch.utils.ckpt_io import read_ckpt
from jarvis_hybridnet_torch.utils.rng import ThreadLocalGenerator
from jarvis_hybridnet_tpu.models.efficienttrack import EfficientTrackBackbone as JaxEfficientTrack
from jarvis_hybridnet_tpu.ops.augment import make_border_zero, make_color_aug
from jarvis_hybridnet_tpu.ops.heatmap import gaussian_heatmaps_on_device
from jarvis_hybridnet_tpu.training import optim as jax_optim
from jarvis_hybridnet_tpu.training.trainer2d import heatmap_loss
from tests.test_torch_graphs import POOL, StandInGraph, fake_cuda  # noqa: F401
from tests.test_torch_models import few_torch_threads  # noqa: F401
from tests.test_torch_training import _jax_v2v_state, _JaxStep, _port_v2v_grads_as_jax, _v2v_state
from tests.test_torch_training2d import _step_batch

pytestmark = pytest.mark.usefixtures("few_torch_threads")
pytest.importorskip("cv2")

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
HYBRID = str(TRAINED / "HybridNet_final.ckpt")
KEYPOINT = str(TRAINED / "KeypointDetect_final.ckpt")
S2D = 64
CONFIG = {
    "DATASET": {"DATASET_2D": "Synth", "DATASET_3D": "Synth"},
    "CENTERDETECT": {"MODEL_SIZE": "small", "IMAGE_SIZE": S2D, "BATCH_SIZE": 2},
    "KEYPOINTDETECT": {"MODEL_SIZE": "small", "NUM_JOINTS": 23, "BOUNDING_BOX_SIZE": 128,
                       "BATCH_SIZE": 2},
    "HYBRIDNET": {"ROI_CUBE_SIZE": 48, "GRID_SPACING": 4, "BATCH_SIZE": 1,
                  "NUM_CAMERAS": 4},
    "TPU": {"REPRO_MODE": "quarter_fused", "TRAIN_DTYPE": "float32"},
    # one producer thread: with the datasets' generators seeded (``seeded``)
    # two runs draw the same host augmentation
    "DATALOADER_NUM_WORKERS": 0,
}
LRS = (1e-3, 4e-4, 2.5e-3, 7e-4)  # a learning rate that changes every step


@pytest.fixture(scope="module")
def parent(tmp_path_factory):
    root = tmp_path_factory.mktemp("parent")
    write_dataset3d(str(root / "datasets" / "Synth"), synthetic_rig(4, 320, 256), 320, 256, 23,
                    splits=(("train", 3), ("val", 2)), extent_mm=40.0, seed=4)
    write_project(str(root), "P", CONFIG)
    return str(root)


def _cfg(parent, **sections):
    pm = ProjectManager(parent)
    assert pm.load("P")
    cfg = pm.get_cfg()
    for section, values in sections.items():
        for k, v in values.items():
            cfg[section][k] = v
    return cfg


@pytest.fixture
def seeded(parent, monkeypatch):
    """The datasets' host augmentation drawn from a fixed seed, so that two
    runs see the same batches; ``JARVIS_PARENT_DIR`` set."""
    init = ThreadLocalGenerator.__init__
    monkeypatch.setattr(ThreadLocalGenerator, "__init__",
                        lambda self, seed=None: init(self, 11 if seed is None else seed))
    monkeypatch.setenv("JARVIS_PARENT_DIR", parent)
    return parent


# ------------------------------------------------------------ stand-in ---

class StandInTrainGraph(StandInGraph):
    def __init__(self, fake):
        super().__init__(fake)
        self.generators = []

    def register_generator_state(self, generator):
        self.generators.append(generator)


def _snapshot(optimizer, generators):
    params = ([p.detach().clone() for g in optimizer.param_groups for p in g["params"]]
              if optimizer is not None else [])
    state = ({p: {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in s.items()}
              for p, s in optimizer.state.items()} if optimizer is not None else {})
    return params, state, [g.get_state() for g in generators]


@torch.no_grad()
def _restore(optimizer, generators, saved):
    params, state, gens = saved
    if optimizer is not None:
        for p, v in zip((p for g in optimizer.param_groups for p in g["params"]), params):
            p.copy_(v)
        for p in list(optimizer.state):
            if p not in state:
                del optimizer.state[p]
        for p, s in state.items():
            for k, v in s.items():
                if isinstance(v, torch.Tensor):
                    optimizer.state[p][k].copy_(v)
                else:
                    optimizer.state[p][k] = v
    for g, st in zip(generators, gens):
        g.set_state(st)


def captured(fake, fn, optimizer, generators):
    """``fn(batch)`` as a capture on the card sees it: under capture the
    step runs, its outputs are kept and what it changed is put back, and the
    graph records a call that runs the step again into the same outputs."""

    def call(batch):
        if fake.capturing is None:
            return fn(batch)
        saved = _snapshot(optimizer, generators)
        out = fn(batch)
        _restore(optimizer, generators, saved)

        def again():
            for o, n in zip(out, fn(batch)):
                o.copy_(n)

        fake.capturing.calls.append(again)
        return out

    return call


@pytest.fixture
def stand_in(fake_cuda, monkeypatch):
    """Every ``TrainGraphs`` of a CPU trainer takes the card's branch on the
    stand-in; ``fake.steps`` lists the graphed steps made, with their kind."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: StandInTrainGraph(fake_cuda))
    fake_cuda.steps = []
    run = graphed.TrainGraphs.run

    def standin_run(self, kind, context, make_fn, batch):
        opt = context[0] if kind == "train" else None

        def make():
            return captured(fake_cuda, make_fn(), opt, (self.generator,))

        return run(self, kind, context, make, batch)

    class Step(graphed.GraphedTrainStep):
        def __init__(self, fn, device, pool=None, generators=()):
            super().__init__(fn, device, POOL if pool is None else pool, generators)
            self.graphed = True  # the card's branch, on the stand-in
            fake_cuda.steps.append(self)

    monkeypatch.setattr(graphed.TrainGraphs, "run", standin_run)
    monkeypatch.setattr(graphed, "GraphedTrainStep", Step)
    return fake_cuda


def _keypoint(cfg, graph, run):
    return EfficientTrackTrainer("KeypointDetect", cfg, weights=KEYPOINT, device="cpu",
                                 run_name=run, graph=graph)


def _batches2d(n=2):
    out = []
    for seed in range(n):
        arrays, _ = host_batch(_step_batch(np.random.default_rng(seed), 2, 23))
        out.append({k: torch.from_numpy(v) for k, v in arrays.items()})
    return out


def _equal_states(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def _moments(opt):
    return [v for s in opt.state.values() for v in s.values() if isinstance(v, torch.Tensor)]


# -------------------------------------------------------- the wrapper ---

def test_warmup_calls_are_real_steps_and_replays_take_the_lr(seeded, stand_in):
    """KeypointDetect in train mode (drop-connect drawn from the trainer's
    generator), AdamW, the lr changed every step, two alternating batches:
    the first WARMUP calls run eagerly, the next captures once, the rest
    replay; after N calls N updates have run, and the parameters, AdamW's
    moments and step count and the generator's state equal N eager steps'
    bit for bit."""
    cfg = _cfg(seeded, KEYPOINTDETECT={"BOUNDING_BOX_SIZE": S2D})
    trainers = [_keypoint(cfg, g, f"W{g}") for g in (True, False)]
    opts = [optim.make_optimizer("adamw", list(t.model.parameters()), LRS[0]) for t in trainers]
    batches = _batches2d()
    for n, lr in enumerate(LRS, start=1):
        outs = [t.train_step(batches[n % 2], o, lr) for t, o in zip(trainers, opts)]
        assert all(torch.equal(a, b) for a, b in zip(*outs))
        assert _equal_states(trainers[0].model, trainers[1].model), n
        assert all(torch.equal(a, b) for a, b in zip(*map(_moments, opts)))
        assert all(float(s["step"]) == n for s in opts[0].state.values())
        assert torch.equal(trainers[0].generator.get_state(), trainers[1].generator.get_state())
    (step,) = stand_in.steps
    assert len(step.graphs) == 1 and len(stand_in.graphs) == 1
    assert sum(step.calls.values()) == graphed.WARMUP
    assert stand_in.graphs[0].generators == [trainers[0].generator]
    assert step.pool is POOL and stand_in.pools == [POOL]


def test_a_step_output_is_unchanged_by_the_next_replay(seeded, stand_in):
    """The trainers read step k's loss after step k + 1 is dispatched: each
    call returns clones, which the next replay does not rewrite."""
    cfg = _cfg(seeded, KEYPOINTDETECT={"BOUNDING_BOX_SIZE": S2D})
    trainer = _keypoint(cfg, True, "Late")
    opt = optim.make_optimizer("adamw", list(trainer.model.parameters()), LRS[0])
    batches = _batches2d()
    outs, kept = [], None
    for n in range(graphed.WARMUP + 3):
        outs.append(trainer.train_step(batches[n % 2], opt, LRS[n % len(LRS)]))
        if kept is not None:
            assert all(torch.equal(a, b) for a, b in zip(outs[-2], kept)), n
        kept = [t.clone() for t in outs[-1]]
    (_, _, static), = stand_in.steps[0].graphs.values()
    for loss, xy in outs[graphed.WARMUP:]:
        assert loss.data_ptr() != static[0].data_ptr() and xy.data_ptr() != static[1].data_ptr()
    assert float(outs[-1][0]) != float(outs[-2][0])


def test_one_capture_per_key(seeded, stand_in, monkeypatch):
    """3D_only on the train split (3 framesets, batch 2: a batch of 2 and a
    short last batch of 1 each epoch, the val split one batch of 2), every
    key captured at its second call (WARMUP 1 here): the short batch is a
    second train key, eval a third, each captured once over two epochs; a
    second ``train()`` call and a new freeze mode capture anew."""
    monkeypatch.setattr(graphed, "WARMUP", 1)
    cfg = _cfg(seeded, HYBRIDNET={"BATCH_SIZE": 2})
    trainer = HybridNetTrainer("train", cfg, weights=HYBRID, device="cpu", run_name="Keys",
                               training_mode="3D_only")
    ds, val = Dataset3D(cfg, set="train"), Dataset3D(cfg, set="val")
    for run, mode in enumerate(("3D_only", "3D_only", "all")):
        trainer.set_training_mode(mode)
        trainer.train(ds, val, num_epochs=2)
        steps = stand_in.steps[2 * run:]
        assert [len(s.graphs) for s in steps] == [2, 1], run
        train_keys = {dict((k, shape) for k, shape, _ in key)["imgs"][0]
                      for key in steps[0].graphs}
        assert train_keys == {1, 2}
    assert len(stand_in.steps) == 6 and len(stand_in.graphs) == 9
    assert all(s.pool is POOL for s in stand_in.steps)


def test_the_eval_step_reads_weights_trained_in_place(seeded):
    """A replay of the train step updates V2V's weights on the card without
    advancing their host version counter, which the no-grad cache of the
    fused up-front conv's kernels was keyed on (a graphed run's epoch-2
    validation read epoch 1's kernels). The trainer turns that cache off:
    after a weight changes in place with no version bump (``.data``), the
    eval step's loss is the loss of the changed weight."""
    cfg = _cfg(seeded)
    trainer = HybridNetTrainer("train", cfg, weights=HYBRID, device="cpu", run_name="Fused",
                               training_mode="3D_only")
    sample = Dataset3D(cfg, set="val", device_targets=True)[0]
    b = {k: torch.from_numpy(np.asarray(sample[k])[None]) for k in BATCH_KEYS}
    before, _ = trainer.eval_step(b)
    (block,) = [m for m in trainer.model.modules() if getattr(m, "fused_up", False)]
    w = block.block[0].weight
    version = w._version
    w.data.mul_(1.5)
    assert w._version == version
    after, _ = trainer.eval_step(b)
    set_fused_cache(trainer.model, True)  # a fresh cache, built from the changed weight
    with torch.no_grad():
        trainer.model.eval()
        want, _ = trainer.forward(b)
    assert float(after) != float(before) and torch.equal(after, want)


def test_train_graphs_drop_a_step_when_its_context_changes():
    """``TrainGraphs``: a step is made anew, with no graph, when its context
    changes; the other kind's step is kept; ``reset`` drops both; disabled,
    the function runs as it is."""
    tg = graphed.TrainGraphs("cpu", torch.Generator())
    made = []

    def make():
        made.append(1)
        return lambda b: (b["x"] * 2,)

    b = {"x": torch.ones(2)}
    tg.run("train", ("opt", "all", True), make, b)
    tg.run("eval", ("all",), make, b)
    tg.run("train", ("opt", "all", True), make, b)
    assert len(made) == 2
    eval_step = tg.steps["eval"][1]
    tg.run("train", ("opt", "all", False), make, b)
    tg.run("train", ("opt2", "all", False), make, b)
    assert len(made) == 4 and tg.steps["eval"][1] is eval_step
    tg.reset()
    assert tg.steps == {}
    off = graphed.TrainGraphs("cpu", None, enabled=False)
    assert torch.equal(off.run("train", (), make, b)[0], torch.full((2,), 2.0))
    assert off.steps == {}


# ------------------------------------------------ whole runs, graph on/off ---

def _train3d(mode, graph, run, epochs=2, resume=None, stop=None):
    res = {}
    with pytest.MonkeyPatch.context() as m:
        if stop is not None:
            m.setattr(preemption.PreemptionGuard, "should_stop_global", stop)
        train_hybridnet("P", epochs, None, HYBRID, mode=mode, run_name=run, device="cpu",
                        results=res, graph=graph, resume=resume)
    return res


@pytest.mark.parametrize("mode", ["3D_only", "all"])
def test_train_hybridnet_graphed_equals_eager(seeded, stand_in, mode):
    """``train_hybridnet`` for 2 epochs on the train split (3 steps of batch
    1 and 2 evaluations an epoch, device color augmentation) with
    ``graph=True`` on the stand-in (2 eager steps, a capture, replays across
    the epoch reseed) against ``graph=False``: the same per-epoch losses and
    accuracies and the same final state, bit for bit."""
    graphed_run = _train3d(mode, True, f"G_{mode}")
    eager_run = _train3d(mode, False, f"E_{mode}")
    assert graphed_run["history"] == eager_run["history"]
    assert _equal_states(graphed_run["trainer"].model, eager_run["trainer"].model)
    train_step, eval_step = stand_in.steps
    assert len(train_step.graphs) == len(eval_step.graphs) == 1


def _stop_at_first_epoch_end(self, stride=None):
    return stride is None


def test_train_state_resumes_across_the_graph_setting(seeded, stand_in):
    """A 3D_only run with ``graph=True`` preempted at the end of epoch 1 and
    resumed with ``graph=False``, and a KeypointDetect run the other way
    round, each end with the parameters of the uninterrupted run of the
    other setting, bit for bit (the val split as the training set, as the
    trainers' resume tests: no host augmentation to replay)."""
    def run(make_trainer, make_set, name, graph, resume=None, stop=False):
        trainer = make_trainer(name, graph)
        with pytest.MonkeyPatch.context() as m:
            if stop:
                m.setattr(preemption.PreemptionGuard, "should_stop_global",
                          _stop_at_first_epoch_end)
            results = trainer.train(make_set(), make_set(), num_epochs=2, resume_from=resume)
        assert results.get("preempted", False) == stop
        return trainer

    cfg = _cfg(seeded, KEYPOINTDETECT={"BOUNDING_BOX_SIZE": S2D})
    cases = {
        "3d": (lambda name, graph: HybridNetTrainer("train", cfg, weights=HYBRID, device="cpu",
                                                    run_name=name, training_mode="3D_only",
                                                    graph=graph),
               lambda: Dataset3D(cfg, set="val"), True),
        "2d": (lambda name, graph: _keypoint(cfg, graph, name),
               lambda: Dataset2D(cfg, set="val", mode="KeypointDetect"), False),
    }
    for case, (make_trainer, make_set, first_graphed) in cases.items():
        whole = run(make_trainer, make_set, f"Whole{case}", not first_graphed)
        first = run(make_trainer, make_set, f"Split{case}", first_graphed, stop=True)
        state = os.path.join(first.model_savepath, "train_state.ckpt")
        resumed = run(make_trainer, make_set, f"Split{case}", not first_graphed, resume=state)
        assert _equal_states(resumed.model, whole.model), case
        assert not _equal_states(first.model, resumed.model), case


def test_train_efficienttrack_graphed_equals_eager(seeded, stand_in):
    """``train_efficienttrack`` for CenterDetect and KeypointDetect, 2 epochs
    (batch 2 of 64^2, device color augmentation), ``graph=True`` on the
    stand-in against ``graph=False``: the same history and final state."""
    for net in ("CenterDetect", "KeypointDetect"):
        runs = []
        for graph in (True, False):
            res = {}
            assert train_efficienttrack(net, "P", 2, KEYPOINT if net == "KeypointDetect"
                                        else None, run_name=f"{net}{graph}", device="cpu",
                                        results=res, graph=graph)
            runs.append(res)
        assert runs[0]["history"] == runs[1]["history"]
        assert _equal_states(runs[0]["trainer"].model, runs[1]["trainer"].model)
    assert all(len(s.graphs) == 1 for s in stand_in.steps) and len(stand_in.steps) == 4


# --------------------------------------------------------- against JAX ---

def test_graphed_3d_step_matches_jax(seeded, stand_in):
    """The graphed 3D_only step (2 eager steps, then a capture and a replay)
    for 3 AdamW steps at a changing lr against JAX's jitted step (its
    ``make_optimizer`` with the same schedule, fed the port's gradients), in
    ``eval()`` as JAX's ``deterministic=True``: the loss within 2e-5
    relative and V2V's parameters within 1e-6 abs + 1e-6 relative after
    every step, the bounds of ``test_training_step_matches_jax``."""
    cfg = _cfg(seeded)
    sample = Dataset3D(cfg, set="val", device_targets=True)[0]
    batch = {k: np.asarray(sample[k])[None] for k in BATCH_KEYS}
    trainer = HybridNetTrainer("train", cfg, weights=HYBRID, device="cpu", run_name="Jax3d",
                               training_mode="3D_only")
    model = trainer.model
    opt = optim.make_optimizer("adamw", optim.apply_freeze(
        model, optim.hybridnet_freeze_labels(model, "3D_only")), LRS[0])
    model.eval()
    ref = _JaxStep(cfg, batch, read_ckpt(HYBRID), "adamw",
                   lambda count: jnp.asarray(LRS, jnp.float32)[count])
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    for step in range(3):
        jl, _ = ref.loss_and_grads()
        loss, _ = trainer.train_step(b, opt, LRS[step])
        assert abs(float(loss) - float(jl)) <= 2e-5 * abs(float(jl)), step
        ref.update(_port_v2v_grads_as_jax(model, ref.params["v2vNet"]))
        want = _jax_v2v_state(ref.params)
        for name, p in _v2v_state(model).items():
            np.testing.assert_allclose(p.numpy(), want[name], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} step {step}")
    (step_obj,) = stand_in.steps
    assert len(step_obj.graphs) == 1


def test_graphed_2d_step_matches_jax(seeded, stand_in):
    """The graphed KeypointDetect step (23 joints, batch 2 of 64^2, K9 with
    a record and a rotated ``minv``) for 3 AdamW steps at a changing lr
    against JAX's ``value_and_grad`` of its own functions and its
    ``make_optimizer`` with the same schedule, fed the port's gradients, in
    ``eval()``: the loss within 1e-5 relative (``test_train_step_matches_jax``'s
    bound) and every parameter within 1e-6 abs + 1e-6 relative after every
    step, the AdamW bound of ``test_training_step_matches_jax`` (the 2D
    test's one step holds 1e-6 abs; from the second step on a fusion weight
    of 76.9 lies one float32 ulp, 7.6e-6, from JAX's: the update's float32
    arithmetic in two orders)."""
    cfg = _cfg(seeded, KEYPOINTDETECT={"BOUNDING_BOX_SIZE": S2D})
    imgs, kps, rec = _step_batch(np.random.default_rng(3), 2, 23)
    jmodel = JaxEfficientTrack(model_size="small", output_channels=23, dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, read_ckpt(KEYPOINT))
    mean = jnp.asarray(cfg.DATASET.MEAN, jnp.float32)
    std = jnp.asarray(cfg.DATASET.STD, jnp.float32)
    color, border = make_color_aug(cfg.AUGMENTATION), make_border_zero()
    jrec = {k: jnp.asarray(v) for k, v in rec.items()}
    kxy = jnp.asarray(kps.reshape(2, -1, 3)[..., :2])

    def loss_fn(p):
        x = border(color(jnp.asarray(imgs, jnp.float32) / 255.0, jrec), jrec["minv"])
        x = (x - mean) / std
        t4 = gaussian_heatmaps_on_device(kxy, S2D, S2D // 4, 1.5 * (S2D // 4) / 64)
        t2 = gaussian_heatmaps_on_device(kxy, S2D, S2D // 2, 1.5 * (S2D // 2) / 64)
        return heatmap_loss(jmodel.apply({"params": p}, x), (t4, t2))

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    tx = jax_optim.make_optimizer("adamw", lambda count: jnp.asarray(LRS, jnp.float32)[count])
    opt_state = tx.init(params)
    trainer = _keypoint(cfg, True, "Jax2d")
    model = trainer.model.eval()
    opt = optim.make_optimizer("adamw", list(model.parameters()), LRS[0])
    arrays, _ = host_batch((imgs, kps, rec))
    b = {k: torch.from_numpy(v) for k, v in arrays.items()}
    for step in range(3):
        jloss, _ = value_and_grad(params)
        loss, _ = trainer.train_step(b, opt, LRS[step])
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss)), step
        grads = efficienttrack_params_to_jax(
            {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}, "small")
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        mine = dict(jax.tree_util.tree_flatten_with_path(efficienttrack_params_to_jax(
            {n: p.detach() for n, p in model.named_parameters()}, "small"))[0])
        for path, want in jax.tree_util.tree_flatten_with_path(params)[0]:
            np.testing.assert_allclose(mine[path], np.asarray(want), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{path} step {step}")
    assert len(stand_in.steps[0].graphs) == 1


# ------------------------------------------------------ the optimizers ---

def _params(seed=0, shapes=((40, 37), (23,), (5, 3, 3, 3))):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(s, generator=g)) for s in shapes]


def _run(opt, params, lrs, seed=1):
    g = torch.Generator().manual_seed(seed)
    grads = []
    for lr in lrs:
        step = [torch.randn(p.shape, generator=g) for p in params]
        grads.append(step)
        for p, gr in zip(params, step):
            p.grad = gr.clone()
        optim.set_learning_rate(opt, lr)
        opt.step()
    return grads


@pytest.mark.parametrize("lrs", [LRS, (1e-3 * 0.2, 1e-3 * 0.2 * 0.2, 5e-5)])
def test_adamw_with_a_tensor_lr_equals_a_float_lr(lrs):
    """The CPU's AdamW of ``make_optimizer`` (a float64 lr tensor written in
    place) against torch's AdamW at the same float lrs, bit for bit (with a
    float32 lr tensor torch's CPU update differs by an ulp in about a tenth
    of the elements)."""
    ours, ref = _params(), _params()
    opt = optim.make_optimizer("adamw", ours, lrs[0])
    lr = opt.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float64 and lr.dim() == 0
    assert not opt.param_groups[0]["capturable"]
    torch_opt = torch.optim.AdamW(ref, lr=lrs[0], betas=optim.ADAM_BETAS, eps=optim.ADAM_EPS,
                                  weight_decay=optim.ADAMW_WEIGHT_DECAY)
    _run(opt, ours, lrs)
    _run(torch_opt, ref, lrs)
    assert opt.param_groups[0]["lr"] is lr and float(lr) == lrs[-1]
    for a, b in zip(ours, ref):
        assert torch.equal(a, b)


def test_nesterov_sgd_matches_optax_and_torch():
    """``NesterovSGD`` for 3 steps at a changing lr; at each step torch's SGD
    (a float lr) and ``optax.sgd(momentum=0.9, nesterov=True)`` take the
    same step from the same parameters, momentum trace and gradients. Each
    parameter lies within one float32 ulp of both, at the scale of the
    step's arithmetic: the largest of |p|, |p'| and lr (1.9 |g| + 0.81
    |trace|), the terms of the update before they cancel (torch fuses the
    last multiply-add, XLA the trace's: rounding in other orders). The
    state is torch SGD's."""
    ours = _params()
    opt = optim.make_optimizer("sgd", ours, LRS[0])
    assert isinstance(opt, optim.NesterovSGD) and isinstance(opt, torch.optim.SGD)
    g = torch.Generator().manual_seed(1)
    for lr in LRS[:3]:
        grads = [torch.randn(p.shape, generator=g) for p in ours]
        before = [p.detach().clone() for p in ours]
        traces = [opt.state[p]["momentum_buffer"].clone() if p in opt.state else None
                  for p in ours]
        for p, gr in zip(ours, grads):
            p.grad = gr.clone()
        optim.set_learning_rate(opt, lr)
        opt.step()
        ref = [torch.nn.Parameter(b.clone()) for b in before]
        torch_opt = torch.optim.SGD(ref, lr=lr, momentum=0.9, nesterov=True)
        for p, t, gr in zip(ref, traces, grads):
            p.grad = gr.clone()
            if t is not None:
                torch_opt.state[p]["momentum_buffer"] = t.clone()
        torch_opt.step()
        tx = optax.sgd(lr, momentum=0.9, nesterov=True)
        params = [jnp.asarray(b.numpy()) for b in before]
        state = tx.init(params)
        state = (state[0]._replace(trace=[jnp.zeros_like(q) if t is None else jnp.asarray(t.numpy())
                                          for q, t in zip(params, traces)]), *state[1:])
        updates, _ = tx.update([jnp.asarray(x.numpy()) for x in grads], state, params)
        jax_params = optax.apply_updates(params, updates)
        for a, b, c, p0, gr, t in zip(ours, ref, jax_params, before, grads, traces):
            a, p0, gr = a.detach().numpy(), p0.numpy(), gr.numpy()
            t = np.zeros_like(gr) if t is None else t.numpy()
            ulp = np.spacing(np.maximum.reduce([np.abs(p0), np.abs(a), np.float32(lr) * (
                1.9 * np.abs(gr) + 0.81 * np.abs(t))]))
            assert (np.abs(a - b.detach().numpy()) <= ulp).all(), lr
            assert (np.abs(a - np.asarray(c)) <= ulp).all(), lr
    assert set(opt.state_dict()["param_groups"][0]) == set(
        torch_opt.state_dict()["param_groups"][0])
    assert [set(s) for s in opt.state_dict()["state"].values()] == [{"momentum_buffer"}] * 3


# ------------------------------------------------------ the train state ---

def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        kind = (tree.dtype.str, tree.shape) if isinstance(tree, np.ndarray) else type(tree)
        yield prefix, kind


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_train_state_leaves_are_unchanged(tmp_path, name):
    """A train state written with ``make_optimizer``'s optimizer (the lr a
    tensor) has the msgpack leaves (paths and types) of one written with
    torch's optimizer at a float lr, the writer before the lr tensor: the lr
    a float, AdamW's step a float32 scalar. Each file resumes in the other
    optimizer (``optim.load_optimizer_state`` keeps the lr tensor and
    writes the loaded lr into it), and a group written on the card
    (``capturable``) resumes on the CPU without it."""
    def make(kind):
        model = EfficientTrackBackbone("small", 3)
        params = list(model.parameters())
        if kind == "ours":
            return model, optim.make_optimizer(name, params, 1e-3)
        if name == "adamw":
            return model, torch.optim.AdamW(params, lr=1e-3, betas=optim.ADAM_BETAS,
                                            eps=optim.ADAM_EPS,
                                            weight_decay=optim.ADAMW_WEIGHT_DECAY)
        return model, torch.optim.SGD(params, lr=1e-3, momentum=0.9, nesterov=True)

    files = {}
    for kind in ("ours", "torch"):
        model, opt = make(kind)
        _run(opt, list(model.parameters()), (1e-3, 5e-4))
        files[kind] = str(tmp_path / f"{kind}.ckpt")
        checkpoints.save_train_state(files[kind], model.state_dict(),
                                     {"optimizer": opt.state_dict(), "step": 2}, 1, "small")
    trees = {k: read_ckpt(f)["opt_state"] for k, f in files.items()}
    assert list(_leaves(trees["ours"])) == list(_leaves(trees["torch"]))
    assert trees["ours"]["optimizer"]["param_groups"][0]["lr"] == 5e-4
    for written, into in (("torch", "ours"), ("ours", "torch")):
        _, opt_state, epoch = checkpoints.load_train_state(files[written], "small")
        model, opt = make(into)
        lr = opt.param_groups[0]["lr"]
        if into == "ours":
            optim.load_optimizer_state(opt, opt_state["optimizer"])
            assert opt.param_groups[0]["lr"] is lr and float(lr) == 5e-4
        else:
            opt.load_state_dict(opt_state["optimizer"])
            assert opt.param_groups[0]["lr"] == 5e-4
        assert len(opt.state) == len(list(model.parameters())) and epoch == 1
        _run(opt, list(model.parameters()), (1e-4,))
    if name == "adamw":
        _, opt_state, _ = checkpoints.load_train_state(files["ours"], "small")
        opt_state["optimizer"]["param_groups"][0]["capturable"] = True
        model, opt = make("ours")
        optim.load_optimizer_state(opt, opt_state["optimizer"])
        assert opt.param_groups[0]["capturable"] is False
        assert all(s["step"].device.type == "cpu" and float(s["step"]) == 2
                   for s in opt.state.values())
        _run(opt, list(model.parameters()), (1e-4,))


# ------------------------------------------------------------- the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py holds every training path's replays "
                    "to its eager steps at full size)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replays_equal_the_eager_steps_on_the_card(seeded, cuda_device):
    """On the card, KeypointDetect in train mode with AdamW at a changing lr
    on two alternating batches: three eager trainers and a graphed one from
    the same checkpoint and seed. Where the eager steps are bit-equal to
    each other, every graphed step (2 eager, a capture, replays) is
    bit-equal to them (loss, argmax, parameters, AdamW's state)."""
    cfg = _cfg(seeded, KEYPOINTDETECT={"BOUNDING_BOX_SIZE": S2D})
    trainers = [EfficientTrackTrainer("KeypointDetect", cfg, weights=KEYPOINT,
                                      device=cuda_device, run_name=f"Card{g}", graph=g)
                for g in (True, False, False)]
    opts = [optim.make_optimizer("adamw", list(t.model.parameters()), LRS[0])
            for t in trainers]
    batches = [{k: v.to(cuda_device) for k, v in b.items()} for b in _batches2d()]
    for n, lr in enumerate(LRS * 2):
        outs = [t.train_step(batches[n % 2], o, lr) for t, o in zip(trainers, opts)]
        states = [[*t.model.state_dict().values(), *_moments(o)]
                  for t, o in zip(trainers, opts)]
        if all(torch.equal(a, b) for a, b in zip(outs[1] + tuple(states[1]),
                                                  outs[2] + tuple(states[2]))):
            assert all(torch.equal(a, b) for a, b in zip(outs[0] + tuple(states[0]),
                                                          outs[1] + tuple(states[1]))), n
    assert len(trainers[0].graphs.steps["train"][1].graphs) == 1


def test_chip_smoke_run_verdict():
    """``chip_smoke.py``'s rule for a graphed ``train()`` against eager runs
    that are not bit-equal (``run_verdict``), on gaps alone: a graphed run
    within twice the eager runs' spread holds; one whose state's largest
    difference, its RMS difference or its history lies beyond twice the
    spread from every eager run is refused; the nearest eager run counts,
    not the first."""
    import itertools

    import chip_smoke

    def gaps(runs, g):
        """(state gap, history gap) from ``g`` to each run and between every
        pair of runs: each run is (largest, RMS, history) on one line."""
        def gap(a, b):
            return (False, abs(a[0] - b[0]), abs(a[1] - b[1])), abs(a[2] - b[2])
        return ([gap(g, e) for e in runs],
                [gap(a, b) for a, b in itertools.combinations(runs, 2)])

    eager = [(0.0, 0.0, 0.0), (1.0, 0.1, 0.02), (0.5, 0.05, 0.01), (0.2, 0.02, 0.05)]
    assert chip_smoke.run_verdict(*gaps(eager, (1.5, 0.15, 0.04)))[0]
    assert chip_smoke.run_verdict(*gaps(eager, (2.9, 0.29, 0.04)))[0]  # 2.9 from the first
    assert chip_smoke.run_verdict(*gaps(eager, (-1.5, -0.15, -0.09)))[0]
    # beyond twice the spread in one of the three
    assert not chip_smoke.run_verdict(*gaps(eager, (3.1, 0.1, 0.02)))[0]
    assert not chip_smoke.run_verdict(*gaps(eager, (1.0, 0.31, 0.02)))[0]
    assert not chip_smoke.run_verdict(*gaps(eager, (1.0, 0.1, 0.16)))[0]
    held, words = chip_smoke.run_verdict(*gaps(eager, (1.0, 0.1, 0.15)))
    assert held and "history 1.000e-01 from the nearest eager run" in words
    assert "the 4 eager runs 5.000e-02 apart" in words
