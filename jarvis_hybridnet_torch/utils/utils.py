"""Run-directory and pretrain listing shared by the command line and the
plots (port of ``jarvis_hybridnet_tpu/utils/utils.py``; reference:
jarvis/utils/utils.py:11-31)."""

from __future__ import annotations

import os

from .clp import CLIColors  # re-export, as the JAX package's module does

__all__ = ["CLIColors", "get_available_pretrains", "list_run_dirs", "latest_run_dir"]


def list_run_dirs(root: str, newest_first: bool = True) -> list[str]:
    """Run names (prediction / analysis output directories) under ``root``,
    sorted by mtime. Non-directories are skipped: a stray file (a log, a
    leftover ``.partNNNNN`` shard) is never offered as a run, nor resolves
    'latest'."""
    if not os.path.isdir(root):
        return []
    return sorted(
        (d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))),
        key=lambda d: os.path.getmtime(os.path.join(root, d)),
        reverse=newest_first,
    )


def latest_run_dir(root: str) -> str | None:
    """Full path of the newest run directory under ``root``, or None."""
    runs = list_run_dirs(root)
    return os.path.join(root, runs[0]) if runs else None


def get_available_pretrains(parent_dir: str) -> list[str]:
    """Named pose pretrains: the subdirectories of ``pretrained/`` that hold
    at least one ``.pth`` or ``.ckpt`` (EcoSet, the backbone pretrain, is
    not a pose pretrain)."""
    pretrain_dir = os.path.join(parent_dir, "pretrained")
    if not os.path.isdir(pretrain_dir):
        return []
    out = []
    for d in sorted(os.listdir(pretrain_dir)):
        full = os.path.join(pretrain_dir, d)
        if d == "EcoSet" or not os.path.isdir(full):
            continue
        if any(f.endswith((".pth", ".ckpt")) for f in os.listdir(full)):
            out.append(d)
    return out
