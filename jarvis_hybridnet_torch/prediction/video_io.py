"""Host-side video decode pipeline.

Replaces the reference's per-frame joblib thread reads
(jarvis/prediction/predict3D.py:75-80) with a prefetching, frame-batching
reader that decodes every camera in its OWN thread (the reference's 12
shared-memory joblib threads, made persistent): each thread owns one
cv2.VideoCapture, decodes sequentially, and writes BGR->RGB converted
frames directly into shared (T, C, H, W, 3) uint8 ring buffers, so both
decode and the ~4 MB/frame color conversion parallelize across cameras.
An emitter publishes each buffer as soon as every camera has filled its
slots, while the device consumes the previous batch — decode and device
compute overlap, bounded by the ring size.

A copy of ``jarvis_hybridnet_tpu/prediction/video_io.py`` for the PyTorch
port. cv2 is imported by the functions that decode with it, not with the
module, and the native readers use the port's own ``native`` libraries.
"""

from __future__ import annotations

import os
import queue
import sys
import threading

import numpy as np


def _cv2():
    import cv2

    return cv2


def get_video_paths(recording_path: str, camera_names: list[str]) -> list[str]:
    """Match video files to calibration camera names
    (reference: predict3D.py:124-133)."""
    videos = os.listdir(recording_path)
    video_paths = []
    for i, camera in enumerate(camera_names):
        for video in videos:
            if camera == video.split(".")[0]:
                video_paths.append(os.path.join(recording_path, video))
        assert len(video_paths) == i + 1, (
            "Missing Recording for camera " + camera
        )
    return video_paths


def probe_frame_count(video_path: str) -> int:
    """Total frame count of a video without opening a full reader."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(video_path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


class MultiCameraReader:
    """Synchronized multi-camera video reader: one decode thread per camera,
    shared ring of batch buffers, bounded prefetch.

    Yields ``(batch, n)`` where batch is (T, C, H, W, 3) uint8 RGB and n is
    the number of valid framesets (the tail batch is partially filled).
    Buffers are recycled when the consumer calls :meth:`recycle`; a consumer
    that never recycles still makes progress (new buffers are allocated up
    to ``max_buffers``) at the cost of extra host memory.

    ``max_buffers`` deliberately stays close to ``prefetch``: once the ring
    is full the decode threads *block* (zero CPU) until the consumer
    recycles. A deep ring lets the decoders run far ahead and, on hosts
    with few cores, starve the consuming thread of CPU — measured on a
    1-core host as >50x end-to-end slowdown with a 16-buffer ring.
    """

    def __init__(
        self,
        video_paths: list[str],
        frame_start: int = 0,
        number_frames: int = -1,
        batch_size: int = 4,
        prefetch: int = 2,
        max_buffers: int | None = None,
        num_threads: int | None = None,
    ):
        if max_buffers is None:
            max_buffers = prefetch + 2
        if num_threads is None:
            # one thread per camera when cores allow (the reference's
            # 12-thread model); on small hosts, partition cameras across
            # cpu_count-1 workers so the decoders cannot starve the
            # consuming thread of CPU (measured 24x end-to-end slowdown
            # with 12 always-runnable decode threads on a 1-core host)
            num_threads = max(1, min(len(video_paths),
                                     (os.cpu_count() or 2) - 1))
        cv2 = self._cv2 = _cv2()
        self.caps = []
        img_size = None
        for path in video_paths:
            cap = cv2.VideoCapture(path)
            if frame_start:
                if int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) > 0:
                    cap.set(cv2.CAP_PROP_POS_FRAMES, frame_start)
                else:
                    # un-indexed container (no frame count): POS_FRAMES
                    # seeks fail silently there, which would misalign
                    # every output row by frame_start — skip sequentially
                    for _ in range(frame_start):
                        if not cap.grab():
                            break
            size = (
                int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            )
            assert img_size is None or img_size == size, (
                "All videos need to have the same resolution"
            )
            img_size = size
            self.caps.append(cap)
        self.img_size = img_size
        total = int(self.caps[0].get(cv2.CAP_PROP_FRAME_COUNT))
        if number_frames == -1:
            # containers without a frame count report 0: decode until the
            # streams exhaust instead of silently yielding nothing
            number_frames = total - frame_start if total > 0 else None
        elif total > 0:
            assert frame_start + number_frames <= total, (
                "make sure your selected segment is not longer than the "
                "total video!"
            )
        self.number_frames = number_frames
        self._limit = (sys.maxsize if number_frames is None
                       else number_frames)
        self.batch_size = batch_size

        C = len(self.caps)
        W, H = img_size
        self._shape = (batch_size, C, H, W, 3)
        self._lock = threading.Condition()
        # ring state (all guarded by _lock):
        self._assigned: list[np.ndarray] = []  # buffer for batch b
        # np.zeros, not np.empty: first-touch faults on numpy's
        # madvise(HUGEPAGE) pages are pathologically slow on some VMs
        # (see native.VideoPool); the ring is written by decode threads
        self._free: list[np.ndarray] = [
            np.zeros(self._shape, np.uint8) for _ in range(prefetch + 1)
        ]
        self._n_alloc = prefetch + 1
        self._max_buffers = max(max_buffers, prefetch + 1)
        self._progress = [0] * C  # frames fully written per camera
        # min frame count of any camera that ended early: no batch at or
        # beyond it can complete, so decode threads must not claim buffers
        # for them — one camera ending more than a ring-capacity before
        # the others would otherwise deadlock the pool (survivors block on
        # buffers the consumer never receives, the emitter waits for the
        # survivors)
        self._effective_end = self._limit
        self._stopped = False
        self._queue: queue.Queue = queue.Queue()

        K = max(1, min(num_threads, C))
        self._threads = [
            threading.Thread(target=self._decode_cameras,
                             args=(list(range(w, C, K)),), daemon=True)
            for w in range(K)
        ]
        self._emitter = threading.Thread(target=self._emit, daemon=True)
        for t in self._threads:
            t.start()
        self._emitter.start()

    # -- producer side ----------------------------------------------------

    def _buffer_for(self, b: int) -> np.ndarray | None:
        """Buffer assigned to batch index b, assigning ring buffers in
        order (blocks when the ring is fully in flight)."""
        with self._lock:
            while len(self._assigned) <= b:
                if self._stopped:
                    return None
                if b * self.batch_size >= self._effective_end:
                    return None
                if self._free:
                    self._assigned.append(self._free.pop())
                elif self._n_alloc < self._max_buffers:
                    self._assigned.append(np.zeros(self._shape, np.uint8))
                    self._n_alloc += 1
                else:
                    self._lock.wait()
            return self._assigned[b]

    def _decode_cameras(self, cams: list[int]):
        """Decode a worker's cameras, interleaved frame-by-frame so every
        camera in the group advances in lockstep (each camera's stream is
        still read strictly sequentially).

        When the stream length is unknown, each new batch's frames are
        probed BEFORE claiming a ring buffer: with a known length the
        loop bound stops exactly at the last frame, but an unknown-length
        stream would otherwise have to acquire a buffer for a phantom
        batch just to discover EOF — and if the consumer holds the whole
        ring (the documented never-recycles contract), that acquisition
        blocks forever with EOF undelivered.
        """
        T = self.batch_size
        live = list(cams)
        probe_eof = self.number_frames is None
        for f in range(self._limit):
            if not live:
                break
            probed = None
            if probe_eof and f % T == 0:
                probed = {}
                for c in list(live):
                    ret, img = self.caps[c].read()
                    if not ret:
                        live.remove(c)
                        with self._lock:
                            self._effective_end = min(self._effective_end,
                                                      self._progress[c])
                            self._progress[c] = -self._progress[c] - 1
                            self._lock.notify_all()
                    else:
                        probed[c] = img
                if not live:
                    break
            buf = self._buffer_for(f // T)
            if buf is None:
                break
            for c in list(live):
                if probed is not None:
                    img, ret = probed[c], True
                else:
                    ret, img = self.caps[c].read()
                if not ret:
                    live.remove(c)
                    with self._lock:
                        self._effective_end = min(self._effective_end,
                                                  self._progress[c])
                        self._progress[c] = -self._progress[c] - 1  # done
                        self._lock.notify_all()
                    continue
                self._cv2.cvtColor(img, self._cv2.COLOR_BGR2RGB,
                                   dst=buf[f % T, c])
            with self._lock:
                for c in live:
                    self._progress[c] = f + 1
                self._lock.notify_all()
        with self._lock:
            for c in live:
                self._progress[c] = -self._progress[c] - 1  # mark done
            self._lock.notify_all()

    @staticmethod
    def _min_progress(progress) -> tuple[int, bool]:
        done = all(p < 0 for p in progress)
        return min(p if p >= 0 else -p - 1 for p in progress), done

    def _emit(self):
        T = self.batch_size
        b = 0
        while True:
            end = min((b + 1) * T, self._limit)
            with self._lock:
                while True:
                    lo, done = self._min_progress(self._progress)
                    if self._stopped:
                        return
                    if lo >= end or done:
                        break
                    self._lock.wait()
                n = min(lo, end) - b * T
                buf = self._assigned[b] if n > 0 else None
                if buf is not None:
                    # drop the producer-side reference: after this, the
                    # buffer is owned by the consumer until recycle()
                    self._assigned[b] = None
            if n <= 0:
                break
            self._queue.put((buf, n))
            if done and lo < (b + 1) * T:
                break
            if end >= self._limit:
                break
            b += 1
        self._queue.put(None)

    # -- consumer side -----------------------------------------------------

    def recycle(self, batch: np.ndarray) -> None:
        """Return a yielded buffer to the ring (call once results that
        depend on it have been fetched)."""
        with self._lock:
            self._free.append(batch)
            self._lock.notify_all()

    def __iter__(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            yield item

    def release(self):
        with self._lock:
            self._stopped = True
            self._lock.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        self._emitter.join(timeout=5)
        for cap in self.caps:
            cap.release()


class SingleVideoReader(MultiCameraReader):
    """Single-camera variant yielding (T, H, W, 3) batches."""

    def __init__(self, video_path: str, **kwargs):
        super().__init__([video_path], **kwargs)

    def __iter__(self):
        for batch, n in super().__iter__():
            yield batch[:, 0], n

    def recycle(self, batch: np.ndarray) -> None:
        # batch is a (T, H, W, 3) view of the underlying (T, 1, H, W, 3)
        # ring buffer; return the base buffer to the ring
        super().recycle(batch.base if batch.base is not None else batch)


class NativeMultiCameraReader:
    """MultiCameraReader backed by the C++ libav pipeline
    (native.VideoPool): demux + decode + RGB conversion run entirely in
    C++ worker threads writing straight into the (T, C, H, W, 3) ring
    buffers, so the Python side only hands buffers to the device and back.
    Same public interface as :class:`MultiCameraReader`."""

    def __init__(
        self,
        video_paths: list[str],
        frame_start: int = 0,
        number_frames: int = -1,
        batch_size: int = 4,
        prefetch: int = 2,
        num_threads: int | None = None,
        lowres_factor: int | None = None,
        max_buffers: int | None = None,
    ):
        from .. import native

        if number_frames != -1:
            probe = native.probe_video(video_paths[0])
            # probe[2] == 0 means the container reports no frame count;
            # an explicit segment request is then taken on faith
            assert probe and (probe[2] <= 0
                              or frame_start + number_frames <= probe[2]), (
                "make sure your selected segment is not longer than the "
                "total video!"
            )
        self._pool = native.VideoPool(
            video_paths, frame_start=frame_start,
            number_frames=number_frames, batch_size=batch_size,
            prefetch=prefetch, num_threads=num_threads,
            lowres_factor=lowres_factor, max_buffers=max_buffers,
        )
        self.img_size = self._pool.img_size
        self.number_frames = self._pool.number_frames
        self.batch_size = batch_size
        self.lowres_factor = lowres_factor

    def __iter__(self):
        return iter(self._pool)

    def recycle(self, batch: np.ndarray) -> None:
        self._pool.recycle(batch)

    def release(self):
        self._pool.release()


class NativeSingleVideoReader(NativeMultiCameraReader):
    """Single-camera native variant yielding (T, H, W, 3) batches."""

    def __init__(self, video_path: str, **kwargs):
        super().__init__([video_path], **kwargs)

    def __iter__(self):
        for batch, n in super().__iter__():
            yield batch[:, 0], n

    def recycle(self, batch: np.ndarray) -> None:
        super().recycle(batch.base if batch.base is not None else batch)


def open_multi_camera_reader(video_paths, backend: str | None = None,
                             **kwargs):
    """Reader factory: the native C++ libav pipeline when available,
    falling back to the cv2-threaded reader. ``backend``: None/'auto',
    'native' (required), or 'cv2' (forced)."""
    if backend in (None, "auto", "native"):
        try:
            from .. import native

            if native.video_available():
                return NativeMultiCameraReader(video_paths, **kwargs)
            if backend == "native":
                raise RuntimeError("native video decode unavailable")
        except Exception:
            if backend == "native":
                raise
    return MultiCameraReader(video_paths, **kwargs)


def open_single_video_reader(video_path: str, backend: str | None = None,
                             **kwargs):
    """Single-video reader factory (see open_multi_camera_reader)."""
    if backend in (None, "auto", "native"):
        try:
            from .. import native

            if native.video_available():
                return NativeSingleVideoReader(video_path, **kwargs)
            if backend == "native":
                raise RuntimeError("native video decode unavailable")
        except Exception:
            if backend == "native":
                raise
    return SingleVideoReader(video_path, **kwargs)
