"""Serving steps as captured CUDA graphs, and exported predictor artifacts
(the port's counterpart of ``jarvis_hybridnet_tpu/prediction/export.py``).

The JAX package jits each serving cascade into one compiled program with
its weights pinned on the device. Here :func:`wrap_predictor` captures a
step function in a ``torch.cuda.CUDAGraph`` per input key (the shapes and
dtypes of its tensor arguments), so that a call issues one graph replay
instead of the step's several hundred launches from Python:

- the first call of a key copies its inputs into static buffers, runs
  ``fn`` eagerly on a side stream ``WARMUP`` times (which builds the nvcc
  kernels, fills the kernel wrappers' cached launch plans and creates the
  counters of ``kernels/build.sync_words``, none of which may happen under
  capture), captures ``fn`` on the static buffers and replays it once;
- each later call copies its inputs into the static buffers on the
  caller's current stream and replays there;
- every call returns clones of the graph's outputs, so a caller that keeps
  one batch's outputs while it dispatches the next (the drivers'
  ``stream_rows``) keeps its own values;
- all graphs of one wrapper share one memory pool
  (``torch.cuda.graph_pool_handle``).

A replay computes bit for bit what the eager step computes on the same
inputs. A capture that fails raises: there is no eager fallback on the
card. On a CPU device the wrapper calls ``fn``, whose kernel wrappers run
their plain versions.

K6, K7, K8 and K10 leave their ``sync_words`` counters ready for their next
call, and those words are shared by every caller of a kernel on one device.
Replays of two graphs that hold the same kernel must therefore never overlap
on two streams: replay every graph on one stream, as the drivers do.

Exported artifacts (the drivers' ``trt_mode`` new / previous, the JAX
package's ``export_predictor`` / ``load_predictor`` / ``list_artifacts`` /
``artifact_path``): :func:`export_predictor` traces a live predictor's whole
cascade with ``torch.export.export`` on its own device, weights inside, and
writes it with ``torch.export.save`` to one ``.pt2`` file per (pipeline,
input shape, ``REPRO_MODE``-``INFERENCE_DTYPE``) under
``projects/<p>/compiled-models/`` (or the directory set in
``compile_cache``). The serving kernels are registered
operators (``kernels/__init__``), so each stays one node of the traced graph;
no compiler runs (no AOTInductor, no ``torch.compile``). :func:`load_predictor`
reads it back with ``torch.export.load(...).module()``: the same ATen
operators and the same hand-written kernels, launched and counted as the
live predictor launches them, so on the same device its outputs equal the
live predictor's bit for bit; on the card its step is a :class:`GraphedStep`
as the live one's is.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
import typing

import torch

WARMUP = 2  # eager calls of a key before its capture


class GraphedStep:
    """``fn`` replayed from one CUDA graph per input key; see the module
    docstring. ``graphed`` is True on a CUDA device; ``captures`` maps each
    key to its capture's wall time in ms (warm-up included)."""

    def __init__(self, fn, device, pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"
        if self.graphed:
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            if pool is None:
                pool = torch.cuda.graph_pool_handle()
        self.pool = pool
        self.graphs: dict = {}  # key -> (graph, static inputs, static outputs)
        self.captures: dict = {}  # key -> ms

    def __call__(self, *args):
        if not self.graphed:
            return self.fn(*args)
        for a in args:
            if not isinstance(a, torch.Tensor) or a.device != self.device:
                raise TypeError(f"a graphed step takes tensors on {self.device}, got "
                                f"{getattr(a, 'device', type(a).__name__)}")
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(key, args)
        else:
            for buf, a in zip(entry[1], args):
                buf.copy_(a)
            entry[0].replay()
        return _clone(entry[2])

    def _capture(self, key, args):
        t0 = time.perf_counter()
        compute = torch.cuda.current_stream(self.device)
        static = [torch.empty_like(a, memory_format=torch.contiguous_format) for a in args]
        for buf, a in zip(static, args):
            buf.copy_(a)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(compute)
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self.fn(*static)
        compute.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with capture(graph, self.pool):
            out = self.fn(*static)
        graph.replay()
        torch.cuda.synchronize(self.device)
        self.captures[key] = (time.perf_counter() - t0) * 1e3
        return graph, static, out


@contextlib.contextmanager
def capture(graph, pool):
    """``torch.cuda.graph(graph, pool=pool)`` with Python's garbage
    collector paused: a collection inside the capture can free a dead
    cycle that holds an earlier graph, whose destruction the capture
    refuses (``cudaErrorStreamCaptureInvalidated``)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            yield
    finally:
        if enabled:
            gc.enable()


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_clone(o) for o in out)


def wrap_predictor(fn, device, pool=None) -> GraphedStep:
    """``fn(*tensors)`` as a :class:`GraphedStep` on ``device``; ``pool``
    (another step's) makes the two share one memory pool, which holds as
    long as their replays run on one stream."""
    return GraphedStep(fn, device, pool)


SUFFIX = ".pt2"


class _Cascade(torch.nn.Module):
    """A live predictor's eager step as the module that ``torch.export``
    traces: its networks as submodules, so their weights are the artifact's
    parameters; the rig and normalization tensors become its constants."""

    def __init__(self, predictor):
        super().__init__()
        self.nets = torch.nn.ModuleList(
            m for m in vars(predictor).values() if isinstance(m, torch.nn.Module))
        self.predictor = predictor

    def forward(self, imgs):
        return self.predictor.eager_step(imgs)


@contextlib.contextmanager
def _only_real_grad_switches():
    """Inside the block a grad-mode switch to the mode in force does
    nothing. ``torch.export`` records every call of
    ``torch._C._set_grad_enabled`` as a node, one that switches nothing too,
    then splits the graph at those nodes and inlines it back: with the
    predictors' ``no_grad`` regions, traced with grad already off, a quarter
    of the trace's time, for a graph with no switch left in it."""
    real = torch._C._set_grad_enabled

    def switch(mode):
        if mode != torch.is_grad_enabled():
            real(mode)

    torch._C._set_grad_enabled = switch
    try:
        yield
    finally:
        torch._C._set_grad_enabled = real


def export_predictor(predictor, example_input, path: str) -> None:
    """Write ``predictor``'s (``Predict3D`` or ``Predict2D``) whole cascade,
    traced on ``example_input``'s shape and dtype (frames as the driver
    feeds them) on the predictor's device, to ``path``."""
    from ..models.v2v import fill_fused_cache

    example = torch.as_tensor(example_input, device=predictor.device)
    cascade = fill_fused_cache(_Cascade(predictor))  # V2V's fused kernels: the live cache
    with torch.no_grad(), _only_real_grad_switches():
        program = torch.export.export(cascade, (example,), strict=False)
    program.example_inputs = None  # a batch of frames: not part of the artifact
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.export.save(program, path)


class LoadedPredictor:
    """An exported cascade read back by :func:`load_predictor`, called as
    the live predictor is: ``predictor(frames) -> (points, confidences,
    valid)`` for frames of the exported shape and dtype, on ``device``.
    ``step`` is the module's call, replayed from a CUDA graph on the card."""

    def __init__(self, module: torch.nn.Module):
        self.module = module.requires_grad_(False)
        self.device = next(module.parameters()).device
        self.step = wrap_predictor(self._forward, self.device)

    @torch.no_grad()
    def _forward(self, imgs):
        return self.module(imgs)

    def __call__(self, imgs):
        return self.step(torch.as_tensor(imgs, device=self.device))


def load_predictor(path: str) -> LoadedPredictor:
    """Load an artifact written by :func:`export_predictor`; returns a
    callable like the original."""
    from .. import kernels  # noqa: F401  (registers the serving ops the graph names)

    with _memoized_type_hints():
        program = torch.export.load(path)
    return LoadedPredictor(program.module())


@contextlib.contextmanager
def _memoized_type_hints():
    """``typing.get_type_hints`` memoized inside the block. ``torch.export``'s
    reader asks it for the hints of its schema's classes again at every
    field of the serialized graph (62,546 times for a predict3D cascade),
    half the load's time; a class's hints do not change while it reads."""
    real, cache = typing.get_type_hints, {}

    def hints(obj, globalns=None, localns=None, include_extras=False):
        try:
            key = (obj, id(globalns), id(localns), include_extras)
            hit = cache.get(key)
        except TypeError:  # an unhashable object: not memoized
            return real(obj, globalns, localns, include_extras)
        if hit is None:
            hit = cache[key] = real(obj, globalns, localns, include_extras)
        return hit

    typing.get_type_hints = hints
    try:
        yield
    finally:
        typing.get_type_hints = real


def list_artifacts(cfg, kind: str) -> list[str]:
    """Saved artifact filenames for ``kind`` under the current numerics
    config (any input shape). Artifacts exported under another repro mode
    or dtype are excluded: the driver would not load them, so offering them
    for reuse (the interactive CLI) would silently build a fresh predictor."""
    probe = artifact_path(cfg, kind, ())
    search, stem = os.path.dirname(probe), os.path.basename(probe)
    tag = stem[len(kind) + 1:]  # "_<tag>.pt2" with the empty shape
    if not os.path.isdir(search):
        return []
    return sorted(f for f in os.listdir(search)
                  if f.startswith(kind + "_") and f.endswith(tag))


def artifact_path(cfg, kind: str, shape) -> str:
    """Canonical artifact location: one file per (pipeline, input shape,
    numerics config); the repro mode and compute dtype are part of the key,
    so changing them never reloads an artifact of other numerics. The JAX
    package's key, with ``.pt2`` for its ``.jaxexp``, in the directory of
    ``compile_cache.artifact_dir``."""
    from .compile_cache import artifact_dir

    tpu = cfg.get("TPU", {})
    tag = (f'{tpu.get("REPRO_MODE", "exact")}-'
           f'{tpu.get("INFERENCE_DTYPE", "bfloat16")}')
    stem = f'{kind}_{"x".join(str(s) for s in shape)}_{tag}{SUFFIX}'
    return os.path.join(artifact_dir(cfg), stem)
