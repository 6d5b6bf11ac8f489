"""The compiled-models directory of ``trt_mode`` new / previous (port of
``jarvis_hybridnet_tpu/prediction/compile_cache.py``).

The JAX package points JAX's persistent compilation cache at
``projects/<p>/compiled-models/`` for ``new`` and ``previous``. The port has
no JIT compiler on its path: the hand-written kernels are built by nvcc
once per source into ``kernels/build/`` (``kernels/build.py``) and PyTorch
runs the rest eagerly or as CUDA graph replays. What the port keeps in that
directory is its exported predictors (``prediction/export.py``), so the
setting here says where those are written and read (:func:`artifact_dir`):

  * 'off'      -> nothing
  * 'new'      -> the project's directory is created and recorded
  * 'previous' -> the same; the drivers load the artifacts found there

A directory recorded by someone else (an embedding application, a test
harness: :func:`set_cache_dir`) is respected, as JAX's is: the artifacts of
every project go there. One this module recorded for another project is
re-pointed on a project switch.
"""

from __future__ import annotations

import os

# The directory in force (None: none), as JAX's ``jax_compilation_cache_dir``
# is one setting of the process, and the one this module last configured,
# which tells "set by us for a (possibly other) project", safe to re-point,
# from "set by someone else", which is respected.
_cache_dir: str | None = None
_configured_dir: str | None = None


def cache_dir() -> str | None:
    """The compiled-models directory in force, or None."""
    return _cache_dir


def set_cache_dir(path: str | None) -> None:
    """Record ``path`` as the directory in force (an outside setting, which
    :func:`configure` then leaves alone and :func:`artifact_dir` returns);
    None clears it."""
    global _cache_dir
    _cache_dir = path


def _foreign() -> bool:
    return bool(_cache_dir) and _cache_dir != _configured_dir


def artifact_dir(cfg) -> str:
    """Where ``cfg``'s exported predictors are written and read: a directory
    set by someone else, else ``projects/<p>/compiled-models/`` of cfg's own
    project."""
    if _foreign():
        return _cache_dir
    return os.path.join(cfg.PARENT_DIR, "projects", str(cfg.PROJECT_NAME), "compiled-models")


def configure(cfg, trt_mode: str) -> None:
    global _configured_dir
    if trt_mode not in ("new", "previous") or _foreign():
        return  # a directory set by someone else is respected
    path = artifact_dir(cfg)
    os.makedirs(path, exist_ok=True)
    set_cache_dir(path)
    _configured_dir = path
