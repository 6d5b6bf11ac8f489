"""Optimizers, LR schedules and the freeze modes (port of
``jarvis_hybridnet_tpu/training/optim.py``).

The JAX package's recipes (the reference's, jarvis/efficienttrack/
efficienttrack.py:72-78, 239-247) in torch, with optax's numbers where torch's
defaults differ:

- AdamW as ``optax.adamw``: betas (0.9, 0.999), eps 1e-8 and weight decay
  **1e-4** (torch's ``AdamW`` defaults to 1e-2), on every trained parameter;
- SGD as ``optax.sgd(momentum=0.9, nesterov=True)``, no weight decay;
- OneCycle by :func:`onecycle_schedule`, the JAX package's formula and phase
  boundary; the trainer sets each step's lr itself (torch's ``OneCycleLR``
  would also cycle the momentum, which optax's schedule does not);
- ReduceLROnPlateau by :class:`PlateauScheduler`, stepped once per epoch on
  the train loss. The JAX step multiplies its update by ``lr / max_lr``,
  which for both optimizers equals running them at that lr.

Frozen parameters (``optax.multi_transform`` with ``set_to_zero`` in JAX)
are kept out of the optimizer and set ``requires_grad_(False)``: no update,
no weight decay. A trained parameter that gets no gradient (one that reaches
no loss) is skipped by AdamW, weight decay included, where optax decays it
(ROADMAP.md C.3).
"""

from __future__ import annotations

import math

import numpy as np
import torch

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
SGD_MOMENTUM = 0.9
TRAINING_MODES = ("all", "bifpn", "last_layers", "3D_only")


def onecycle_schedule(max_lr: float, total_steps: int, pct_start: float = 0.3,
                      div_factor: float = 100.0, final_div_factor: float = 1e4):
    """torch's OneCycleLR ('cos') as the JAX package computes it, in float32,
    with its phase-boundary convention (phase 1 ends at ``pct_start *
    total_steps - 1``). Returns ``schedule(step) -> lr``."""
    f32 = np.float32
    initial = max_lr / div_factor
    min_lr = initial / final_div_factor
    phase1_end = f32(float(pct_start * total_steps) - 1.0)
    phase2_len = f32(float(total_steps - 1) - float(phase1_end))
    pi = f32(math.pi)

    def schedule(step: int) -> float:
        s = f32(step)
        pct1 = np.clip(s / phase1_end, f32(0), f32(1))
        up = f32(max_lr) + f32((initial - max_lr) / 2.0) * (f32(1) + np.cos(pi * pct1))
        pct2 = np.clip((s - phase1_end) / phase2_len, f32(0), f32(1))
        down = f32(min_lr) + f32((max_lr - min_lr) / 2.0) * (f32(1) + np.cos(pi * pct2))
        return float(up if s <= phase1_end else down)

    return schedule


class PlateauScheduler:
    """Host-side ReduceLROnPlateau state (torch defaults used by the
    reference: factor 0.2, patience 3, min_lr 5e-5, stepped once per epoch
    on the train loss)."""

    def __init__(self, initial_lr: float, factor: float = 0.2,
                 patience: int = 3, min_lr: float = 5e-5):
        self.lr = initial_lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr


def make_optimizer(optimizer_name: str, params, learning_rate: float) -> torch.optim.Optimizer:
    """'adamw' or 'sgd' over ``params`` (the trained parameters only)."""
    if optimizer_name == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS,
                                 weight_decay=ADAMW_WEIGHT_DECAY)
    return torch.optim.SGD(params, lr=learning_rate, momentum=SGD_MOMENTUM, nesterov=True)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def hybridnet_freeze_labels(model: torch.nn.Module, mode: str) -> dict[str, str]:
    """'train' / 'freeze' for every parameter name of a HybridNetBackbone,
    as the JAX package labels its tree (jarvis/hybridnet/hybridnet.py:
    367-388): V2V always trains; 'all' trains the 2D net too, 'bifpn'
    freezes its backbone, 'last_layers' its backbone and BiFPN, '3D_only'
    all of it."""
    if mode not in TRAINING_MODES:
        raise ValueError(f"unknown training mode {mode!r}")

    def label(name: str) -> str:
        parts = name.split(".")
        if parts[0] != "effTrack" or mode == "all":
            return "train"
        if mode == "bifpn":
            return "freeze" if parts[1] == "backbone_net" else "train"
        if mode == "last_layers":
            return "freeze" if parts[1] in ("backbone_net", "bifpn") else "train"
        return "freeze"

    return {name: label(name) for name, _ in model.named_parameters()}


def apply_freeze(model: torch.nn.Module, labels: dict[str, str]) -> list[torch.nn.Parameter]:
    """Set ``requires_grad`` from ``labels``; the trained parameters, in the
    model's order."""
    trained = []
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
        if labels[name] == "train":
            trained.append(p)
    return trained
