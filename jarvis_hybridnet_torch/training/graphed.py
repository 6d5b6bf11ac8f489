"""Train and eval steps as captured CUDA graphs (the port's counterpart of
the JAX package's jitted ``train_step`` / ``eval_step``,
``jarvis_hybridnet_tpu/training/trainer3d.py:161-191`` and
``trainer2d.py:164-210``).

The serving wrapper (``prediction/export.py``) may run its step more often
than it is called: its warm-up repeats a step without side effects. A train
step changes state (the parameters, the optimizer's moments and step count,
the generator the dropout and drop-connect masks are drawn from), so every
call of :class:`GraphedTrainStep` is exactly one step:

- the first ``WARMUP`` calls of a key (the names, shapes and dtypes of the
  batch's tensors) run the step eagerly on a side stream, on the caller's
  batch: real steps, which build the nvcc kernels, the wrappers' cached
  launch plans, ``kernels/build.sync_words`` and the optimizer's state,
  none of which may be created under capture;
- the next call copies the batch into static buffers, captures the step on
  them and replays it once: that replay is the call's step;
- every later call copies the batch into the static buffers and replays,
  on the caller's stream.

The learning rate is no input of the graph: the optimizer's groups hold it
as a device tensor (``optim.make_optimizer``) that ``optim.set_learning_rate``
writes in place on the caller's stream before the call, and the captured
update reads it. The generators the step draws from are registered with
each graph (``CUDAGraph.register_generator_state``): a capture draws
nothing, a replay draws at the generator's offset and advances it as the
eager step does, and a ``manual_seed`` between replays holds for the next.
Every call returns clones of the step's outputs, so the trainers'
one-step-late readback reads its own step's loss after the next replay.

:class:`TrainGraphs` holds a trainer's two steps, train and eval, in one
memory pool (export's rule): their replays run one after another on the
caller's stream, and no graph reads memory of the pool that it did not
write in the same replay (the optimizer's state, the lr, the static inputs
and ``sync_words`` lie outside the pool), so neither can clobber what the
other needs. A step is dropped, with its graphs, when its context changes:
the optimizer, the freeze mode or ``model.training`` for training, the
freeze mode for evaluation; the trainers drop both at the start of every
``train()``, as the JAX trainers jit fresh closures per call. A capture
that fails raises: there is no eager fallback on the card. On a CPU device
(or with ``graph=False``) the step runs as it is.

Under a mesh of processes (``parallel/``) the sharded step's all-reduce of
the gradients and the loss runs inside the captured step: NCCL's
collectives are captured as graph nodes, and the ``WARMUP`` eager steps run
them first, as a capture needs. gloo's cannot be captured: a gloo mesh on
the card takes ``graph=False`` (:func:`check_capturable` raises otherwise).
"""

from __future__ import annotations

import time

import torch

from ..prediction.export import _clone, capture

WARMUP = 2  # eager steps of a key before its capture


def check_capturable(graph: bool, device, mesh) -> None:
    """Raise where a trainer's steps are to be captured on the card (``graph``
    on a CUDA device) while their collectives run on gloo."""
    if graph and torch.device(device).type == "cuda" and mesh is not None \
            and mesh.backend != "nccl":
        raise ValueError(f"a {mesh.backend} collective cannot be captured in a CUDA graph; "
                         "pass graph=False, or run the mesh on NCCL")


def rank_device(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current device
    (``cuda:LOCAL_RANK`` once ``multihost.initialize_distributed`` ran)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class GraphedTrainStep:
    """``fn(batch)`` (a dict of tensors -> a tuple of tensors), one step a
    call, replayed from one CUDA graph per key after ``WARMUP`` eager steps
    (module docstring). ``graphed`` is True on a CUDA device; ``captures``
    maps each key to its capture's wall time in ms (capture and first
    replay); ``pool`` is the graphs' memory pool."""

    def __init__(self, fn, device, pool=None, generators=()):
        self.fn = fn
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"
        if self.graphed:
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            if pool is None:
                pool = torch.cuda.graph_pool_handle()
        self.pool = pool
        self.generators = tuple(generators)
        self.calls: dict = {}  # key -> eager calls so far
        self.graphs: dict = {}  # key -> (graph, static batch, static outputs)
        self.captures: dict = {}  # key -> ms

    def __call__(self, batch: dict):
        if not self.graphed:
            return self.fn(batch)
        for name, t in batch.items():
            if not isinstance(t, torch.Tensor) or t.device != self.device:
                raise TypeError(f"a graphed step takes tensors on {self.device}, got {name} "
                                f"on {getattr(t, 'device', type(t).__name__)}")
        key = tuple((name, tuple(t.shape), t.dtype) for name, t in sorted(batch.items()))
        entry = self.graphs.get(key)
        if entry is not None:
            for name, buf in entry[1].items():
                buf.copy_(batch[name])
            entry[0].replay()
        elif self.calls.get(key, 0) < WARMUP:
            self.calls[key] = self.calls.get(key, 0) + 1
            return self._eager(batch)
        else:
            entry = self.graphs[key] = self._capture(key, batch)
        return _clone(entry[2])

    def _eager(self, batch: dict):
        compute = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(compute)
        with torch.cuda.stream(side):
            out = self.fn(batch)
        compute.wait_stream(side)
        return _clone(out)

    def _capture(self, key, batch: dict):
        t0 = time.perf_counter()
        static = {name: torch.empty_like(t, memory_format=torch.contiguous_format)
                  for name, t in batch.items()}
        for name, buf in static.items():
            buf.copy_(batch[name])
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with capture(graph, self.pool):
            out = self.fn(static)
        graph.replay()
        torch.cuda.synchronize(self.device)
        self.captures[key] = (time.perf_counter() - t0) * 1e3
        return graph, static, out


class TrainGraphs:
    """A trainer's train and eval steps (module docstring): ``run(kind,
    context, make_fn, batch)`` calls ``make_fn()(batch)`` as it is when
    ``enabled`` is False, else through the ``GraphedTrainStep`` of ``kind``
    made from ``make_fn()`` for ``context``, dropped and made anew when
    ``context`` changes."""

    def __init__(self, device, generator, enabled: bool = True):
        self.device = torch.device(device)
        self.generator = generator
        self.enabled = enabled
        self.steps: dict = {}  # kind -> (context, GraphedTrainStep)

    def reset(self) -> None:
        self.steps = {}

    def run(self, kind: str, context: tuple, make_fn, batch: dict):
        if not self.enabled:
            return make_fn()(batch)
        held = self.steps.get(kind)
        if held is None or held[0] != context:
            others = [s for k, (_, s) in self.steps.items() if k != kind]
            pool = others[0].pool if others else None
            held = self.steps[kind] = (context, GraphedTrainStep(
                make_fn(), self.device, pool, (self.generator,)))
        return held[1](batch)
