"""ctypes bindings for the native host libraries: the video decoder
(libjarvis_video.so) and the JPEG decode + crop of the 3D training dataset
(libjarvis_host.so).

A copy of the video part and of ``available`` / ``decode_crop_batch`` of
``jarvis_hybridnet_tpu/native/__init__.py`` (:142, :380); the port builds
its own libraries from the sources beside this file, on demand, with the
bundled Makefile (g++, the libav libraries or libjpeg, and pthreads). When
the toolchain or a library is unavailable, ``load_video()`` / ``load()``
return None and the callers decode with cv2 instead: host decode is the
JAX package's choice of reader, not a device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(__file__)
_LIB_PATH = os.path.join(_DIR, "libjarvis_host.so")
_VIDEO_LIB_PATH = os.path.join(_DIR, "libjarvis_video.so")
_lib = None
_tried = False
_video_lib = None
_video_tried = False


def _build(target: str) -> bool:
    try:
        subprocess.run(
            ["make", "-C", _DIR, "-s", target], check=True,
            capture_output=True, timeout=120,
        )
        return True
    except Exception:
        return False


def load():
    """Load (building if necessary) the JPEG decode + crop library; None
    when g++ or libjpeg is unavailable (the dataset then decodes with cv2)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _build("libjarvis_host.so") and not os.path.isfile(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.jh_decode_crop_batch.restype = ctypes.c_int
    lib.jh_decode_crop_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def decode_crop_batch(paths: list[str], centers: np.ndarray, bbox: int,
                      width: int, height: int,
                      num_threads: int | None = None) -> np.ndarray | None:
    """Threaded decode + centered crop -> (n, bbox, bbox, 3) uint8.
    centers: (n, 2) int32 (x, y), clamped inside the frame like the
    reference's crop logic."""
    lib = load()
    if lib is None:
        return None
    if num_threads is None:
        num_threads = min(len(paths), os.cpu_count() or 1)
    centers = np.ascontiguousarray(centers, np.int32)
    out = np.empty((len(paths), bbox, bbox, 3), np.uint8)
    ok = lib.jh_decode_crop_batch(
        _c_paths(paths), len(paths),
        centers.ctypes.data_as(ctypes.c_void_p), bbox,
        out.ctypes.data_as(ctypes.c_void_p), width, height, num_threads,
    )
    return out if ok == len(paths) else None


def load_video():
    """Load (building if necessary) the native video decode library
    (libavformat/libavcodec); None when the toolchain or ffmpeg dev
    libraries are unavailable — callers fall back to cv2."""
    global _video_lib, _video_tried
    if _video_lib is not None or _video_tried:
        return _video_lib
    _video_tried = True
    # always invoke make: it is a no-op when the .so is newer than the
    # source, and rebuilds a stale library after a .cpp edit (checking
    # only os.path.isfile would silently keep loading the old binary)
    if not _build("libjarvis_video.so") and not os.path.isfile(_VIDEO_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_VIDEO_LIB_PATH)
    except OSError:
        return None

    c = ctypes
    lib.jv_probe.restype = c.c_int
    lib.jv_probe.argtypes = [c.c_char_p, c.POINTER(c.c_int32),
                             c.POINTER(c.c_int32), c.POINTER(c.c_int64)]
    lib.jv_open.restype = c.c_void_p
    lib.jv_open.argtypes = [c.c_char_p, c.c_int64]
    lib.jv_info.restype = None
    lib.jv_info.argtypes = [c.c_void_p, c.POINTER(c.c_int32),
                            c.POINTER(c.c_int32), c.POINTER(c.c_int64)]
    lib.jv_read.restype = c.c_int
    lib.jv_read.argtypes = [c.c_void_p, c.c_void_p]
    lib.jv_close.restype = None
    lib.jv_close.argtypes = [c.c_void_p]
    lib.jv_pool_create.restype = c.c_void_p
    lib.jv_pool_create.argtypes = [
        c.POINTER(c.c_char_p), c.c_int32, c.c_int64, c.c_int64, c.c_int32,
        c.POINTER(c.c_void_p), c.c_int32, c.c_int32,
    ]
    lib.jv_pool_create2.restype = c.c_void_p
    lib.jv_pool_create2.argtypes = [
        c.POINTER(c.c_char_p), c.c_int32, c.c_int64, c.c_int64, c.c_int32,
        c.POINTER(c.c_void_p), c.c_int32, c.c_int32,
        c.POINTER(c.c_void_p), c.c_int32, c.c_int32,
    ]
    lib.jv_pool_info.restype = None
    lib.jv_pool_info.argtypes = [c.c_void_p, c.POINTER(c.c_int32),
                                 c.POINTER(c.c_int32), c.POINTER(c.c_int64)]
    lib.jv_pool_next.restype = c.c_int32
    lib.jv_pool_next.argtypes = [c.c_void_p, c.POINTER(c.c_int32)]
    lib.jv_pool_recycle.restype = None
    lib.jv_pool_recycle.argtypes = [c.c_void_p, c.c_int32]
    lib.jv_pool_destroy.restype = None
    lib.jv_pool_destroy.argtypes = [c.c_void_p]
    _video_lib = lib
    return _video_lib


def video_available() -> bool:
    return load_video() is not None


def probe_video(path: str) -> tuple[int, int, int] | None:
    """(width, height, n_frames) of a video, or None."""
    lib = load_video()
    if lib is None:
        return None
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    n = ctypes.c_int64()
    if lib.jv_probe(path.encode(), ctypes.byref(w), ctypes.byref(h),
                    ctypes.byref(n)) != 0:
        return None
    return int(w.value), int(h.value), int(n.value)


class VideoReader:
    """Sequential single-video RGB24 decoder (native libav)."""

    def __init__(self, path: str, frame_start: int = 0):
        lib = load_video()
        if lib is None:
            raise RuntimeError("native video decode unavailable")
        self._lib = lib
        self._handle = lib.jv_open(path.encode(), frame_start)
        if not self._handle:
            raise RuntimeError(f"could not open video: {path}")
        w = ctypes.c_int32()
        h = ctypes.c_int32()
        n = ctypes.c_int64()
        lib.jv_info(self._handle, ctypes.byref(w), ctypes.byref(h),
                    ctypes.byref(n))
        self.width, self.height = int(w.value), int(h.value)
        self.n_frames = int(n.value)

    def read(self, out: np.ndarray | None = None) -> np.ndarray | None:
        """Next frame as (H, W, 3) RGB uint8 (into ``out`` when given);
        None at end of stream."""
        if out is None:
            out = np.empty((self.height, self.width, 3), np.uint8)
        ret = self._lib.jv_read(self._handle,
                                out.ctypes.data_as(ctypes.c_void_p))
        if ret != 0:
            return None
        return out

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.jv_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class VideoPool:
    """Multi-camera ring-buffer decode pipeline (C++ worker threads).

    Decodes C synchronized camera streams into caller-visible numpy ring
    buffers of shape (T, C, H, W, 3) uint8 RGB — the fused predictor's
    input layout. ``next()`` blocks for the next complete batch and
    returns ``(buffer, n)``; the caller must hand the buffer back with
    ``recycle()`` once its H2D transfer has completed.
    """

    def __init__(self, paths: list[str], frame_start: int = 0,
                 number_frames: int = -1, batch_size: int = 4,
                 prefetch: int = 2, num_threads: int | None = None,
                 lowres_factor: int | None = None,
                 max_buffers: int | None = None):
        lib = load_video()
        if lib is None:
            raise RuntimeError("native video decode unavailable")
        self._lib = lib
        probe = probe_video(paths[0])
        if probe is None:
            raise RuntimeError(f"could not open video: {paths[0]}")
        W, H, _ = probe
        C = len(paths)
        # ring size follows MultiCameraReader's contract: a consumer that
        # never recycles still receives up to max_buffers batches before
        # the decode threads block (cv2 path grows lazily; here the ring
        # is pre-allocated, so size it to the max up front)
        if max_buffers is None:
            max_buffers = prefetch + 2
        n_buffers = max(max_buffers, prefetch + 1)
        # np.zeros, NOT np.empty: the ring is written first from the C++
        # decode threads, and first-touch faults on numpy's
        # madvise(HUGEPAGE) empty-allocated pages measured 70x slower than
        # calloc-backed pages on ballooned VMs (0.24 vs 16.5 framesets/s).
        self.buffers = [
            np.zeros((batch_size, C, H, W, 3), np.uint8)
            for _ in range(n_buffers)
        ]
        bufs = (ctypes.c_void_p * n_buffers)(
            *[b.ctypes.data_as(ctypes.c_void_p).value for b in self.buffers]
        )
        self.lowres_factor = lowres_factor
        self.low_buffers = None
        low_args = (None, 0, 0)
        if lowres_factor:
            lw, lh = W // lowres_factor, H // lowres_factor
            self.low_buffers = [
                np.zeros((batch_size, C, lh, lw, 3), np.uint8)
                for _ in range(n_buffers)
            ]
            lbufs = (ctypes.c_void_p * n_buffers)(
                *[b.ctypes.data_as(ctypes.c_void_p).value
                  for b in self.low_buffers]
            )
            low_args = (lbufs, lw, lh)
            self.low_size = (lw, lh)
        if num_threads is None:
            num_threads = max(1, min(C, (os.cpu_count() or 2) - 1))
        cpaths = _c_paths(paths)
        self._handle = lib.jv_pool_create2(
            cpaths, C, frame_start, number_frames, batch_size, bufs,
            n_buffers, num_threads, *low_args,
        )
        if not self._handle:
            raise RuntimeError("could not open camera videos "
                               "(missing file or resolution mismatch?)")
        w = ctypes.c_int32()
        h = ctypes.c_int32()
        n = ctypes.c_int64()
        lib.jv_pool_info(self._handle, ctypes.byref(w), ctypes.byref(h),
                         ctypes.byref(n))
        self.img_size = (int(w.value), int(h.value))
        # INT64_MAX marks "decode until EOF" (the container reported no
        # frame count); surface that as None so progress displays show
        # an unknown total instead of a 9-quintillion one
        self.number_frames = (int(n.value)
                              if n.value < 2**62 else None)
        self.batch_size = batch_size
        self._buf_index = {b.ctypes.data: i
                           for i, b in enumerate(self.buffers)}

    def next(self):
        """(full, n) — or (full, low, n) when ``lowres_factor`` is set —
        for the next complete batch; None when exhausted."""
        n = ctypes.c_int32()
        idx = self._lib.jv_pool_next(self._handle, ctypes.byref(n))
        if idx < 0:
            return None
        if self.low_buffers is not None:
            return self.buffers[idx], self.low_buffers[idx], int(n.value)
        return self.buffers[idx], int(n.value)

    def __iter__(self):
        while True:
            item = self.next()
            if item is None:
                return
            yield item

    def recycle(self, buffer: np.ndarray) -> None:
        base = buffer.base if buffer.base is not None else buffer
        self._lib.jv_pool_recycle(self._handle,
                                  self._buf_index[base.ctypes.data])

    def release(self):
        if getattr(self, "_handle", None):
            self._lib.jv_pool_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


def _c_paths(paths: list[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr
