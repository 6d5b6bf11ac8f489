"""Serving steps as captured CUDA graphs (the port's counterpart of
``jarvis_hybridnet_tpu/prediction/export.py::wrap_predictor``).

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

``export_predictor`` / ``load_predictor`` (a step compiled ahead of time and
reloaded, JAX's ``trt_mode`` new / previous) wait for ROADMAP.md A.13.
"""

from __future__ import annotations

import time

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
        with torch.cuda.graph(graph, pool=self.pool):
            out = self.fn(*static)
        graph.replay()
        torch.cuda.synchronize(self.device)
        self.captures[key] = (time.perf_counter() - t0) * 1e3
        return graph, static, out


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_clone(o) for o in out)


def wrap_predictor(fn, device, pool=None) -> GraphedStep:
    """``fn(*tensors)`` as a :class:`GraphedStep` on ``device``; ``pool``
    (another step's) makes the two share one memory pool, which holds as
    long as their replays run on one stream."""
    return GraphedStep(fn, device, pool)
