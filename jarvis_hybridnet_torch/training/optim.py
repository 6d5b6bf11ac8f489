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

The learning rate is a 0-d tensor on the parameters' device in every
param group, which :func:`set_learning_rate` writes in place: a captured
update (``training/graphed.py``) reads the value of its replay's step, as
JAX's jitted step takes ``lr_scale`` as an argument. On the card AdamW is
built ``capturable`` (its step count and bias correction on the device) and
the lr is float32, for eager steps and replays alike; on the CPU, where
torch refuses ``capturable``, the lr is float64, so that torch's CPU update,
which computes its step size in the lr's dtype, is bit for bit the update
at a float lr. SGD is :class:`NesterovSGD`, whose update reads the lr tensor
on the device on both (torch's multi-tensor SGD reads it on the host).

The train state holds the optimizer's state as the JAX package writes it
(:func:`optax_state`, read back by :func:`load_optax_state`): flax's
``to_state_dict`` of ``make_optimizer``'s optax state, with AdamW's
``exp_avg`` / ``exp_avg_sq`` as ``mu`` / ``nu``, ``NesterovSGD``'s
``momentum_buffer`` as ``trace``, each in the JAX parameter tree
(``models/weights.params_to_jax``), and the trainer's step count as every
int32 ``count``.

Frozen parameters (``optax.multi_transform`` with ``set_to_zero`` in JAX)
are kept out of the optimizer and set ``requires_grad_(False)``: no update,
no weight decay. A trained parameter that reaches no loss gets a zero
gradient before the step (:func:`fill_missing_grads`), as JAX's
``value_and_grad`` gives every trained leaf one: AdamW then decays it and
steps its moments, and SGD its momentum, as optax does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.weights import params_from_jax, params_to_jax

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
    """'adamw' or 'sgd' over ``params`` (the trained parameters only), with
    the lr tensor of the module docstring on their device."""
    params = list(params)
    device = params[0].device
    on_card = device.type == "cuda"
    lr = torch.tensor(learning_rate, dtype=torch.float32 if on_card else torch.float64,
                      device=device)
    if optimizer_name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                                weight_decay=ADAMW_WEIGHT_DECAY, capturable=on_card)
        # the eager step is capturable on purpose, to compute as the replays
        # do: no warning that it runs outside a capture
        opt._warned_capturable_if_run_uncaptured = True
        return opt
    return NesterovSGD(params, lr)


class NesterovSGD(torch.optim.SGD):
    """``optax.sgd(momentum=0.9, nesterov=True)``, no weight decay, as device
    ops that read the group's lr tensor: trace = momentum * trace + grad
    (the first step's trace is the gradient), param -= lr * (grad + momentum
    * trace). torch's SGD computes the same (within a float32 ulp), but its
    multi-tensor update reads a tensor lr on the host, which a capture
    refuses. The groups and the ``momentum_buffer`` state are torch's SGD's,
    so a train state written with torch's SGD resumes here."""

    def __init__(self, params, lr):
        super().__init__(params, lr=lr, momentum=SGD_MOMENTUM, nesterov=True)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            momentum = group["momentum"]
            bufs = []
            for p, g in zip(params, grads):
                state = self.state[p]
                buf = state.get("momentum_buffer")
                if buf is None:
                    buf = state["momentum_buffer"] = g.detach().clone()
                else:
                    buf.mul_(momentum).add_(g)
                bufs.append(buf)
            updates = torch._foreach_add(grads, bufs, alpha=momentum)
            torch._foreach_mul_(updates, group["lr"])
            torch._foreach_sub_(params, updates)


def fill_missing_grads(optimizer: torch.optim.Optimizer) -> None:
    """A zero gradient for every parameter of the optimizer's groups that the
    backward left without one, so that the step decays and moves it as
    optax's does a leaf whose gradient is zero."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """``lr`` into every group: in place into a tensor lr (on the card a
    launch on the caller's stream, ahead of the step that reads it), else
    as a float."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


# the group keys that choose torch's update implementation
_IMPLEMENTATION = ("capturable", "foreach", "fused", "differentiable")


def load_optimizer_state(optimizer: torch.optim.Optimizer, state_dict: dict) -> None:
    """``optimizer.load_state_dict(state_dict)``, keeping what
    :func:`make_optimizer` built: each group's lr tensor (the loaded lr
    written into it) and the flags that choose the update's implementation,
    and a capturable optimizer's step counts on its parameters' device. So a
    train state written with a float lr, or on another device, resumes
    here, before any step is captured."""
    built = [{k: v for k, v in g.items() if k != "params"} for g in optimizer.param_groups]
    optimizer.load_state_dict(state_dict)
    for group, kept in zip(optimizer.param_groups, built):
        if isinstance(kept["lr"], torch.Tensor):
            kept["lr"].fill_(float(group["lr"]))
            group["lr"] = kept["lr"]
        group.update({k: kept[k] for k in _IMPLEMENTATION if k in kept})
        if group.get("capturable"):
            for p in group["params"]:
                state = optimizer.state.get(p, {})
                if "step" in state:
                    state["step"] = state["step"].to(device=p.device, dtype=torch.float32)


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


def _frozen(keys: tuple, mode: str | None) -> bool:
    """Whether the JAX tree's leaf at ``keys`` is frozen in freeze ``mode``
    (the JAX package's ``hybridnet_freeze_labels``; None: nothing is)."""
    if mode is None or keys[0] != "effTrack" or mode == "all":
        return False
    if mode == "bifpn":
        return keys[1] == "backbone_net"
    if mode == "last_layers":
        return keys[1] == "backbone_net" or keys[1].startswith("bifpn")
    return True


def _masked(tree, mode: str | None, keys: tuple = ()):
    """``tree`` with ``{}`` at every frozen leaf, as flax writes the
    ``MaskedNode`` of ``optax.multi_transform``'s trained branch."""
    if isinstance(tree, dict):
        return {k: _masked(v, mode, keys + (k,)) for k, v in tree.items()}
    return {} if _frozen(keys, mode) else tree


def _filled(tree, template):
    """``tree`` with zeros of ``template``'s leaf where it holds ``{}``."""
    if isinstance(template, dict):
        return {k: _filled(tree[k], v) for k, v in template.items()}
    return np.zeros_like(template) if isinstance(tree, dict) else tree


def param_names(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> list[str]:
    """The names of ``optimizer``'s parameters in its order (the keys of its
    ``state_dict()["state"]``)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def optax_state(opt_sd: dict, names: list[str], state: dict, step: int, onecycle: bool,
                model_size: str, freeze_mode: str | None = None) -> dict:
    """The optimizer state of ``opt_sd`` (an ``Optimizer.state_dict()`` over
    the parameters ``names``) as flax's ``to_state_dict`` writes the JAX
    package's optax state (``make_optimizer``): AdamW ``{"0": {"count", "mu",
    "nu"}, "1": {}, "2": {"count"} | {}}``, SGD ``{"0": {"trace"}, "1":
    {"count"} | {}}``, the last ``count`` there under OneCycle (``onecycle``)
    and ``{}`` under the plateau's constant rate; with a ``freeze_mode``
    (HybridNet, always labelled) inside ``multi_transform``'s
    ``inner_states`` with ``{}`` at every frozen leaf. ``state`` (the model's
    state dict) gives the untrained tensors' shapes; a trained tensor without
    a slot yet (no step taken) writes zeros, as ``tx.init`` does. Every count
    is ``step`` as int32."""
    adam = "betas" in opt_sd["param_groups"][0]

    def tree(slot: str) -> dict:
        sd = {k: torch.zeros(v.shape) for k, v in state.items()}
        for i, name in enumerate(names):
            v = opt_sd["state"].get(i, {}).get(slot)
            if v is not None:
                sd[name] = v
        return _masked(params_to_jax(sd, model_size), freeze_mode)

    count = np.asarray(step, np.int32)
    schedule = {"count": count} if onecycle else {}
    if adam:
        inner = {"0": {"count": count, "mu": tree("exp_avg"), "nu": tree("exp_avg_sq")},
                 "1": {}, "2": schedule}
    else:
        inner = {"0": {"trace": tree("momentum_buffer")}, "1": schedule}
    if freeze_mode is None:
        return inner
    return {"inner_states": {"train": {"inner_state": inner}, "freeze": {"inner_state": {}}}}


def load_optax_state(optimizer: torch.optim.Optimizer, names: list[str], tree: dict,
                     state: dict, model_size: str) -> int:
    """Fill ``optimizer``'s state (over the parameters ``names``) from an
    optimizer state in the JAX package's layout (:func:`optax_state`; a file
    of either package), and return its step count: AdamW's ``count``, else
    the schedule's (0 under the plateau, whose SGD state holds none).
    ``mu`` / ``nu`` / ``trace`` become ``exp_avg`` / ``exp_avg_sq`` /
    ``momentum_buffer`` in the parameters' dtype and device, and AdamW's
    per-parameter ``step`` is the count as a float32 scalar, on the
    parameters' device in a ``capturable`` group. ``state`` (the model's
    state dict) gives the shapes of the leaves a frozen tensor leaves
    empty."""
    inner = tree["inner_states"]["train"]["inner_state"] if "inner_states" in tree else tree
    first = inner["0"]
    adam = isinstance(optimizer, torch.optim.AdamW)
    if adam != ("mu" in first):
        raise ValueError(f"the train state holds {'AdamW' if 'mu' in first else 'SGD'}'s "
                         f"state, the run trains with {type(optimizer).__name__}")
    schedule = inner["2" if adam else "1"]
    step = int(first["count"] if adam else schedule.get("count", 0))
    template = params_to_jax(state, model_size)

    def torch_sd(t: dict) -> dict:
        return params_from_jax(_filled(t, template), model_size)

    slots = ({"exp_avg": torch_sd(first["mu"]), "exp_avg_sq": torch_sd(first["nu"])} if adam
             else {"momentum_buffer": torch_sd(first["trace"])})
    params = [(p, g) for g in optimizer.param_groups for p in g["params"]]
    for (p, group), name in zip(params, names, strict=True):
        entry = {}
        if adam:  # first, as torch's AdamW orders its state
            entry["step"] = torch.tensor(float(step), dtype=torch.float32,
                                         device=p.device if group.get("capturable") else "cpu")
        entry.update({k: v[name].to(device=p.device, dtype=p.dtype) for k, v in slots.items()})
        optimizer.state[p] = entry
    return step
