"""Build the CUDA sources in ``csrc/`` into shared libraries, bound by ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into ``build/lib<name>-<hash>.so``, where the hash covers the source, the
shared headers and the flags: an edited source gets a new library and a
stale one is never loaded; nvcc's output is kept beside it (``log_path``).
A library is built at its first use, or all of them at once, one ``nvcc``
each in parallel, by :func:`build_all`. The C
functions take raw pointers and the stream as ``void*`` and return
``cudaGetLastError()`` after the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("instance_norm_act", "repro_quarter_gather", "repro_grid_gather",
           "soft_argmax", "resize_normalize", "instance_norm_act_backward", "hybridnet_loss",
           "heatmap2d_loss", "color_aug", "argmax2d", "repro_gather_backward",
           "repro_grid_gather_backward")

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
# The repro index arithmetic must round after every operation, as the JAX
# reference does; the sources use __f*_rn intrinsics and this flag keeps
# nvcc from contracting anything else into an FMA. soft_argmax flushes
# denormals, which drops the scaling around its exp2 / log2 operations. K8
# and K9 round every product before its sum, as their plain versions do,
# and so do K11 / K12 in their transposed stencils.
# ptxas reports K5's-K12's registers and spills into their build logs.
_EXTRA_FLAGS = {"repro_quarter_gather": ["--fmad=false"],
                "repro_grid_gather": ["--fmad=false", "-Xptxas=-v"],
                "soft_argmax": ["-ftz=true"],
                "instance_norm_act_backward": ["-Xptxas=-v"],
                "hybridnet_loss": ["-Xptxas=-v"],
                "heatmap2d_loss": ["--fmad=false", "-Xptxas=-v"],
                "color_aug": ["--fmad=false", "-Xptxas=-v"],
                "argmax2d": ["-Xptxas=-v"],
                "repro_gather_backward": ["--fmad=false", "-Xptxas=-v"],
                "repro_grid_gather_backward": ["--fmad=false", "-Xptxas=-v"]}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _flags(name: str) -> list[str]:
    return _FLAGS + _EXTRA_FLAGS.get(name, [])


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for one source unless its library is already built."""
    out = _target(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    log_path(name).write_text(log)
    os.replace(tmp, out)


def log_path(name: str) -> Path:
    """nvcc's output for the current library of ``csrc/<name>.cu``."""
    return _target(name).with_suffix(".log")


def build_all() -> None:
    """Compile every source, one nvcc process each, all at once."""
    with _lock:
        jobs = {n: _start(n) for n in SOURCES}
        errors = []
        for n, job in jobs.items():
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def bind(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """One C function of a kernel library with its argument types set."""
    fn = getattr(library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def stream() -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def require(t, name: str, dtypes, ndim: int | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of an accepted type."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


_words: dict = {}


def sync_words(device, name: str, count: int = 2):
    """``count`` int32 words on ``device`` for the kernel ``name`` (a grid
    barrier's or a ticket's counter, K10's keys), zeroed once, at the
    kernel's first call of that count; the kernel leaves them ready for its
    next call. They are made outside CUDA graph capture, so a captured call
    finds them."""
    import torch

    key = (name, str(device), count)
    words = _words.get(key)
    if words is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: call it once before capturing it in a CUDA graph")
        words = _words[key] = torch.zeros(count, dtype=torch.int32, device=device)
    return words


def no_output(like):
    """The empty float32 tensor a registered op returns on ``like``'s
    device in place of an output it was not asked for (an op's outputs are
    fixed by its schema)."""
    import torch

    return like.new_empty((0,), dtype=torch.float32)


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when all are on one CUDA device (the kernel runs)."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {sorted(kinds)}")
