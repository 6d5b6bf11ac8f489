"""Host-to-device copies that overlap the device's work.

The JAX package hands each batch to ``jax.device_put``, which returns at
once while the copy runs (``jarvis_hybridnet_tpu/prediction/predict3d.py:
348-350``). :class:`HostToDevice` is the port's counterpart on a CUDA
device: each call copies its host arrays into one of a pair of pinned
staging buffers (a host memcpy), starts the copies to the device with
``non_blocking=True`` on a side stream, records an event there, and makes
the caller's (compute) stream wait on that event. The host goes on at once;
the device copy of batch k + 1 runs while batch k computes. A staging slot
is reused two calls later, after its event has completed. The device
tensors are allocated on the side stream and marked as used by the compute
stream (``record_stream``), so the allocator does not hand their memory out
again before the compute that reads them has run.

The copy into the staging buffer is done when a call returns, so the
caller's host arrays are free then: the device copy reads only the
staging buffer. On the CPU a call returns tensors that share the host
arrays' memory, which stay in use until the work on them has run.
"""

from __future__ import annotations

import numpy as np
import torch


class HostToDevice:
    def __init__(self, device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._staging: list[dict] = [{}, {}]
        self._events: list = [None, None]
        self._slot = 0

    def __call__(self, arrays):
        """``arrays``: one numpy array, or a dict whose numpy values are
        copied (other values pass through). Returns the same structure of
        tensors on the device."""
        single = isinstance(arrays, np.ndarray)
        items = {"": arrays} if single else arrays
        if not self._cuda:
            out = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                   for k, v in items.items()}
            return out[""] if single else out
        slot, self._slot = self._slot, self._slot ^ 1
        if self._events[slot] is not None:
            self._events[slot].synchronize()  # this slot's previous copy has landed
        staging = self._staging[slot]
        compute = torch.cuda.current_stream(self.device)
        out = {}
        with torch.cuda.stream(self._stream):
            for k, v in items.items():
                if not isinstance(v, np.ndarray):
                    out[k] = v
                    continue
                src = torch.from_numpy(np.ascontiguousarray(v))
                buf = staging.get(k)
                if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                    buf = staging[k] = torch.empty(src.shape, dtype=src.dtype,
                                                   pin_memory=True)
                buf.copy_(src)
                dev = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                dev.copy_(buf, non_blocking=True)
                dev.record_stream(compute)
                out[k] = dev
            event = torch.cuda.Event()
            event.record(self._stream)
        compute.wait_event(event)
        self._events[slot] = event
        return out[""] if single else out
