"""The rank programs of the multi-process tests (``tests/test_torch_parallel*.py``).

:func:`run_ranks` starts ``world`` processes with the ``spawn`` method, each
joining a gloo group through a ``file://`` store under the test's temporary
directory (no port is shared between test workers), with a 60 s timeout on
every collective, and joins them under a deadline: a hang fails the test
instead of running the suite into its cap. Each rank's program returns a
picklable result, saved to ``rank<r>.pt``; a rank that raises writes its
traceback, which the test reports.

This module imports nothing of JAX, so a spawned rank starts light.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import time
import traceback

import numpy as np
import torch

TIMEOUT = datetime.timedelta(seconds=60)
TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
CENTER = str(TRAINED / "CenterDetect_final.ckpt")
HYBRID = str(TRAINED / "HybridNet_final.ckpt")


def run_ranks(fn, world: int, tmp_path, *args, deadline: float = 240.0, env=None) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned gloo ranks; their
    results in rank order. Raises if a rank fails or the deadline passes."""
    import torch.multiprocessing as mp

    out = pathlib.Path(tmp_path) / f"ranks_{fn.__name__}_{time.monotonic_ns()}"
    out.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(out), args, env or {}))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [(out / f"error{r}.txt").read_text() for r in range(world)
              if (out / f"error{r}.txt").exists()]
    if errors:
        raise AssertionError("a rank failed:\n" + "\n".join(errors))
    if hung:
        raise AssertionError(f"ranks {hung} did not finish within {deadline} s")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    assert not bad, f"ranks exited with {bad}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _entry(fn, rank: int, world: int, out: str, args, env) -> None:
    os.environ.update(env)
    torch.set_num_threads(2)
    from jarvis_hybridnet_torch.parallel import multihost

    try:
        multihost.initialize_distributed("gloo", f"file://{out}/store", world, rank, TIMEOUT)
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out, f"error{rank}.txt"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)


def project_cfg(parent: str, **tpu):
    """The config of project ``P`` under ``parent`` (``test_torch_training``'s
    layout), with ``TPU`` keys set."""
    from jarvis_hybridnet_torch.config.project_manager import ProjectManager

    pm = ProjectManager(parent)
    assert pm.load("P")
    cfg = pm.get_cfg()
    for k, v in tpu.items():
        cfg.TPU[k] = v
    return cfg


def hybridnet_steps(cfg, batch: dict, mode: str, mesh, steps: int = 2, lr: float = 1e-3,
                    run_name: str = "step", train: bool = True,
                    optimizer: str = "sgd") -> dict:
    """``steps`` ``optimizer`` steps of ``HybridNetTrainer`` in freeze ``mode`` (in
    ``train()``: dropout and drop-connect on; in ``eval()`` with ``train``
    False) on ``batch`` (numpy, the global batch), sharded over ``mesh`` or
    on one process: per step the loss, the points, and every trained
    tensor's gradient and value."""
    from jarvis_hybridnet_torch.parallel.train_step import shard_batch
    from jarvis_hybridnet_torch.training import optim
    from jarvis_hybridnet_torch.training.trainer3d import HybridNetTrainer

    trainer = HybridNetTrainer("train", cfg, weights=HYBRID, device="cpu", run_name=run_name,
                               training_mode=mode, graph=False, mesh=mesh)
    model = trainer.model
    trained = optim.apply_freeze(model, optim.hybridnet_freeze_labels(model, mode))
    opt = optim.make_optimizer(optimizer, trained, lr)
    model.train(train)
    B, C = batch["imgs"].shape[:2]
    rows = slice(None) if mesh is None else mesh.batch(B)
    b = shard_batch({k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in batch.items()},
                    mesh, C)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    out = {"loss": [], "points": [], "grads": [], "params": [],
           "before": {n: p.detach().clone() for n, p in model.named_parameters()
                      if p.requires_grad}}
    for _ in range(steps):
        loss, points = trainer.train_step(b, opt, lr)
        params = dict(model.named_parameters())
        out["loss"].append(float(loss))
        out["points"].append(points.detach().clone())
        out["grads"].append({n: params[n].grad.detach().clone() for n in names})
        out["params"].append({n: params[n].detach().clone() for n in names})
    return out


def train3d(rank: int, world: int, parent: str, n_data: int, n_cam: int, combos, batch) -> dict:
    """:func:`hybridnet_steps` of every (freeze mode, repro mode) of
    ``combos`` on an ``n_data x n_cam`` mesh."""
    from jarvis_hybridnet_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_data, n_cam, timeout=TIMEOUT)
    os.environ["JARVIS_PARENT_DIR"] = parent
    return {(mode, repro): hybridnet_steps(project_cfg(parent, REPRO_MODE=repro), batch, mode,
                                           mesh, run_name=f"r{rank}_{mode}_{repro}")
            for mode, repro in combos}


def train3d_eval(rank: int, world: int, parent: str, batch) -> float:
    """The loss of one step of mode ``all`` (quarter_fused) in ``eval()`` on
    a 2 x 2 mesh."""
    from jarvis_hybridnet_torch.parallel.mesh import make_mesh

    os.environ["JARVIS_PARENT_DIR"] = parent
    out = hybridnet_steps(project_cfg(parent, REPRO_MODE="quarter_fused"), batch, "all",
                          make_mesh(2, 2, timeout=TIMEOUT), steps=1, run_name=f"e{rank}",
                          train=False)
    return out["loss"][0]


def efficienttrack_steps(cfg, batch: dict, mesh, steps: int = 2, lr: float = 1e-3,
                         run_name: str = "step2d", optimizer: str = "sgd") -> dict:
    """``steps`` ``optimizer`` steps of a KeypointDetect ``EfficientTrackTrainer`` (in
    ``train()``) on ``batch`` (numpy ``imgs``, ``kxy``: the global batch),
    data-parallel over ``mesh`` or on one process: per step the loss, the
    argmax, every gradient and parameter."""
    from jarvis_hybridnet_torch.training import optim
    from jarvis_hybridnet_torch.training.trainer2d import EfficientTrackTrainer

    cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE = batch["imgs"].shape[1]
    trainer = EfficientTrackTrainer("KeypointDetect", cfg, weights=None, device="cpu",
                                    run_name=run_name, graph=False, mesh=mesh)
    model = trainer.model
    opt = optim.make_optimizer(optimizer, list(model.parameters()), lr)
    model.train()
    rows = slice(None) if mesh is None else mesh.batch(batch["imgs"].shape[0])
    b = {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in batch.items()}
    out = {"loss": [], "xy": [], "grads": [], "params": [],
           "before": {n: p.detach().clone() for n, p in model.named_parameters()}}
    for _ in range(steps):
        loss, xy = trainer.train_step(b, opt, lr)
        out["loss"].append(float(loss))
        out["xy"].append(xy.clone())
        out["grads"].append({n: p.grad.detach().clone() for n, p in model.named_parameters()})
        out["params"].append({n: p.detach().clone() for n, p in model.named_parameters()})
    return out


def train2d(rank: int, world: int, parent: str, batch) -> dict:
    from jarvis_hybridnet_torch.parallel.mesh import make_mesh

    os.environ["JARVIS_PARENT_DIR"] = parent
    return efficienttrack_steps(project_cfg(parent), batch, make_mesh(world, timeout=TIMEOUT),
                                run_name=f"r{rank}_2d")


def preempt(rank: int, world: int, parent: str, signal_rank: int) -> dict:
    """``HybridNetTrainer.train`` (3D_only, 2 epochs, a global batch of 2
    over a data mesh of ``world``), ``signal_rank`` sending itself SIGTERM
    after its first step: the steps each rank ran and its results."""
    import signal

    from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
    from jarvis_hybridnet_torch.parallel.mesh import make_mesh
    from jarvis_hybridnet_torch.training.trainer3d import HybridNetTrainer

    os.environ["JARVIS_PARENT_DIR"] = parent
    cfg = project_cfg(parent)
    cfg.HYBRIDNET.BATCH_SIZE = 2
    trainer = HybridNetTrainer("train", cfg, weights=HYBRID, device="cpu",
                               run_name=f"Pre_r{rank}", training_mode="3D_only", graph=False,
                               mesh=make_mesh(world, timeout=TIMEOUT))
    calls = []
    step = trainer.train_step

    def counted(b, optimizer, lr):
        out = step(b, optimizer, lr)
        calls.append(int(b["imgs"].shape[0]))
        if rank == signal_rank and len(calls) == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.train_step = counted
    results = trainer.train(Dataset3D(cfg, set="train"), Dataset3D(cfg, set="val"), 2)
    return {"calls": calls, "preempted": results.get("preempted", False),
            "savepath": trainer.model_savepath,
            "params": {n: p.detach().clone() for n, p in trainer.model.named_parameters()}}


def predict3d(rank: int, world: int, cfg, rig, frames, n_data: int, n_cam: int) -> dict:
    """The sharded float32 predict3D of this rank's part of ``frames`` (T, C,
    H, W, 3): its framesets and, with ``n_cam`` > 1, its cameras."""
    from jarvis_hybridnet_torch.parallel.mesh import make_mesh
    from jarvis_hybridnet_torch.parallel.predict_step import build_sharded_predict3d

    mesh = make_mesh(n_data, n_cam, timeout=TIMEOUT)
    predictor = build_sharded_predict3d(cfg, rig, CENTER, HYBRID, mesh=mesh, dtype="float32",
                                        shard_cameras=n_cam > 1, device="cpu", graph=False)
    T, C = frames.shape[:2]
    mine = frames[mesh.batch(T), mesh.cameras(C)]
    center_hm, center3d, valid = predictor.centers(torch.from_numpy(mine))
    points, conf, valid2 = predictor(mine)
    return {"points": points, "conf": conf, "valid": valid, "center_hm": center_hm,
            "center3d": center3d, "valid2": valid2, "mesh": (mesh.data_index, mesh.camera_index)}


def predict2d(rank: int, world: int, cfg, frames) -> dict:
    """The data-parallel float32 predict2D of this rank's frames."""
    from jarvis_hybridnet_torch.parallel.mesh import make_mesh
    from jarvis_hybridnet_torch.parallel.predict_step import build_sharded_predict2d

    mesh = make_mesh(world, timeout=TIMEOUT)
    predictor = build_sharded_predict2d(cfg, CENTER, str(TRAINED / "KeypointDetect_final.ckpt"),
                                        mesh=mesh, dtype="float32", device="cpu", graph=False)
    return dict(zip(("points", "conf", "valid"), predictor(frames[mesh.batch(len(frames))])))


def drivers(rank: int, world: int, root: str, params3d: dict, params2d: dict) -> dict:
    """The predict3D and predict2D drivers of project ``params*['project_name']``
    under ``root`` on this rank of the world."""
    from jarvis_hybridnet_torch.prediction.predict2d import predict2D
    from jarvis_hybridnet_torch.prediction.predict3d import predict3D
    from jarvis_hybridnet_torch.utils.param_classes import Predict2DParams, Predict3DParams

    os.environ["JARVIS_PARENT_DIR"] = root
    return {"3d": predict3D(Predict3DParams(**params3d), device="cpu"),
            "2d": predict2D(Predict2DParams(**params2d), device="cpu")}
