"""The train state in the JAX package's layout, across the two packages, on
the CPU.

The port writes ``{"params", "opt_state", "epoch"}`` as the JAX package's
``save_train_state`` does: the optimizer state is flax's ``to_state_dict``
of ``make_optimizer``'s optax state (``optim.optax_state``). For the
EfficientTrack (2D) with AdamW and SGD under OneCycle and under the
plateau's constant rate, and for HybridNet in ``all`` and ``3D_only``
(always labelled, ``{}`` at the frozen tensors), from the committed
MonkeyHand checkpoints and seeded gradients fed to both packages:

- a state the port wrote after two steps restores through JAX's
  ``load_train_state(path, tx.init(params))`` with every leaf of
  ``tx.init``'s dtype and shape and the port's values, and JAX's next optax
  update from it lands within one float32 ulp of the port's next step
  under the same gradient for SGD (C.3's bound, at the scale of the step's
  terms); for AdamW within two, torch rounding its decay (C.3's ulp) apart
  from the step, plus the error of optax's float32 bias corrections, which
  torch computes in float64 (3.6e-6 of the third step): the two
  optimizers' own gap, whatever the state;
- a state JAX's ``save_train_state`` wrote after two updates resumes in the
  port (``checkpoints.load_train_state`` + ``restore_optimizer``) at the
  same step, and the port's next step lands as close to JAX's.

AdamW as the card builds it (``capturable``: the step count a float32
tensor, the bias corrections computed in float32 as optax computes them,
the lr a float32 tensor) crosses both ways within the same two ulps and four
roundings of the step with no bias-correction term: that term is the CPU
group's float64 corrections alone. One ulp does not hold there either: the
capturable step folds lr / (1 - b1 ** t) into the denominator, another
order of roundings than optax's (up to 5 ulps of the step's scale).

A file in the port's earlier layout (torch's ``Optimizer.state_dict()``)
still loads (``test_torch_dataset3d.py::test_train_state_round_trip``).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from jarvis_hybridnet_torch.models.efficienttrack import EfficientTrackBackbone
from jarvis_hybridnet_torch.models.hybridnet import HybridNetBackbone
from jarvis_hybridnet_torch.models.weights import params_from_jax, params_to_jax
from jarvis_hybridnet_torch.training import checkpoints, optim
from jarvis_hybridnet_torch.utils.ckpt_io import read_ckpt
from jarvis_hybridnet_tpu.training import checkpoints as jax_checkpoints
from jarvis_hybridnet_tpu.training import optim as jax_optim

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
MAX_LR, TOTAL = 3e-3, 10
CASES = [("2D", None, "adamw", True), ("2D", None, "adamw", False),
         ("2D", None, "sgd", True), ("2D", None, "sgd", False),
         ("3D", "all", "adamw", True), ("3D", "all", "sgd", False),
         ("3D", "3D_only", "adamw", True), ("3D", "3D_only", "sgd", False)]
IDS = [f"{net}{'-' + mode if mode else ''}-{opt}-{'onecycle' if oc else 'plateau'}"
       for net, mode, opt, oc in CASES]


def _model(net: str):
    if net == "2D":
        model = EfficientTrackBackbone("small", 23)
        ckpt = TRAINED / "KeypointDetect_final.ckpt"
    else:
        model = HybridNetBackbone(num_joints=23, model_size="small", roi_cube_size=48,
                                  grid_spacing=4, repro_mode="quarter_fused")
        ckpt = TRAINED / "HybridNet_final.ckpt"
    model.load_state_dict(params_from_jax(read_ckpt(str(ckpt)), "small"), strict=True)
    return model


class _Port:
    """The port's optimizer over the trained tensors of a model, as the
    trainers build it on the CPU, or with ``capturable`` AdamW as
    ``optim.make_optimizer`` builds it on the card."""

    def __init__(self, net, mode, name, onecycle, capturable=False):
        self.model, self.mode, self.onecycle = _model(net), mode, onecycle
        if mode is None:
            trained = list(self.model.parameters())
        else:
            trained = optim.apply_freeze(
                self.model, optim.hybridnet_freeze_labels(self.model, mode))
        if capturable:
            self.opt = torch.optim.AdamW(
                trained, lr=torch.tensor(MAX_LR, dtype=torch.float32), betas=optim.ADAM_BETAS,
                eps=optim.ADAM_EPS, weight_decay=optim.ADAMW_WEIGHT_DECAY, capturable=True)
            self.opt._warned_capturable_if_run_uncaptured = True
        else:
            self.opt = optim.make_optimizer(name, trained, MAX_LR)
        self.names = optim.param_names(self.model, self.opt)
        self.schedule = (optim.onecycle_schedule(MAX_LR, TOTAL) if onecycle
                         else (lambda step: MAX_LR))

    def step(self, grads: dict, step: int) -> None:
        for n, p in self.model.named_parameters():
            if p.requires_grad:
                p.grad = grads[n].clone()
        optim.set_learning_rate(self.opt, self.schedule(step))
        self.opt.step()

    def save(self, path, step, epoch=1) -> None:
        state = self.model.state_dict()
        checkpoints.save_train_state(
            path, state, optim.optax_state(self.opt.state_dict(), self.names, state, step,
                                           self.onecycle, "small", self.mode), epoch, "small")

    def params(self) -> dict:
        """The parameters as the JAX tree, copied (``params_to_jax`` leaves
        share the memory of contiguous tensors, which the next step
        changes in place)."""
        return jax.tree.map(np.copy, params_to_jax(self.model.state_dict(), "small"))


def _grads(model, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {n: 0.05 * torch.randn(p.shape, generator=g) for n, p in model.named_parameters()}


class _Jax:
    """JAX's optimizer for a case, its init and update jitted once (eager
    JAX compiles every op at every leaf's shape: 30 s for the 2D tree's
    update against about 5 s)."""

    def __init__(self, params, mode, name, onecycle):
        lr = jax_optim.onecycle_schedule(MAX_LR, TOTAL) if onecycle else MAX_LR
        labels = None if mode is None else jax_optim.hybridnet_freeze_labels(params, mode)
        self.tx = jax_optim.make_optimizer(name, lr, labels)
        self.init = jax.jit(self.tx.init)

        @jax.jit
        def update(params, state, grads):
            updates, state = self.tx.update(grads, state, params)
            return optax.apply_updates(params, updates), state

        self._update = update

    def update(self, params, state, grads: dict):
        return self._update(params, state, jax.tree.map(jnp.asarray,
                                                        params_to_jax(grads, "small")))


def _bias_correction_error(t: int) -> float:
    """The relative error that optax's AdamW adds to step ``t`` against
    torch's on the CPU: optax computes the bias corrections ``1 - b ** t``
    in float32 (``1 - 0.999 ** 3`` 6.6e-6 off), torch in float64; the update
    moves by the first's error and half the second's (its square root)."""
    err = []
    for b in optim.ADAM_BETAS:
        f32 = 1.0 - float(np.float32(b) ** np.float32(t))
        err.append(abs(f32 - (1.0 - b ** t)) / (1.0 - b ** t))
    return err[0] + err[1] / 2


def _within_one_ulp(port: dict, want, before: dict, lr: float, extra: float,
                    where: str) -> None:
    """Each parameter within one float32 ulp of JAX's at the scale of the
    step's terms (the largest of |p| before and after and lr, the size of
    an AdamW step; an SGD step's terms are below it at these gradients).
    AdamW (``extra`` not None): one ulp for the decay, which torch rounds
    apart from the step (C.3), and one for the step, plus ``extra`` (optax's
    float32 bias corrections against the CPU group's float64 ones) and four
    float32 roundings of the step, relative to the step."""
    got = dict(jax.tree_util.tree_flatten_with_path(port)[0])
    base = dict(jax.tree_util.tree_flatten_with_path(before)[0])
    n = 0
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        a, w, p0 = got[path], np.asarray(w), np.asarray(base[path])
        ulp = np.spacing(np.maximum.reduce([np.abs(p0), np.abs(a), np.abs(w),
                                            np.full_like(a, lr)]).astype(np.float32))
        # AdamW: torch rounds the decay (C.3's ulp) and the step apart
        tol = ulp if extra is None else 2 * ulp + np.abs(w - p0) * (extra + 4 * 2.0 ** -24)
        assert (np.abs(a - w) <= tol).all(), (where, path, float(np.abs(a - w).max()))
        n += 1
    assert n == len(got)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(serialization.to_state_dict(tree))[0]


@pytest.mark.parametrize("net,mode,name,onecycle", CASES, ids=IDS)
def test_train_state_crosses_between_packages(tmp_path, net, mode, name, onecycle):
    """Port to JAX, then JAX to the port, for one case (module docstring)."""
    _cross(tmp_path, net, mode, name, onecycle)


@pytest.mark.parametrize("net,mode,onecycle", [("2D", None, True), ("2D", None, False),
                                               ("3D", "all", True)],
                         ids=["2D-onecycle", "2D-plateau", "3D-all-onecycle"])
def test_capturable_adamw_crosses_without_the_bias_correction_term(tmp_path, monkeypatch,
                                                                   net, mode, onecycle):
    """The card's ``capturable`` AdamW (float32 bias corrections, as optax)
    crosses both ways within two ulps and four roundings of the step, with
    no bias-correction term (module docstring). torch runs a capturable
    group on the card only; its arithmetic is the same tensor ops on the
    CPU, so the test lets the CPU through torch's device check."""
    import torch.optim.adam as torch_adam

    devices = torch_adam._get_capturable_supported_devices
    monkeypatch.setattr(torch_adam, "_get_capturable_supported_devices",
                        lambda *a, **k: [*devices(*a, **k), "cpu"])
    _cross(tmp_path, net, mode, "adamw", onecycle, capturable=True)


def _cross(tmp_path, net, mode, name, onecycle, capturable=False):
    port = _Port(net, mode, name, onecycle, capturable)
    params0 = jax.tree.map(jnp.asarray, port.params())
    ref = _Jax(params0, mode, name, onecycle)
    # the CPU's AdamW computes the bias corrections in float64, optax and a
    # capturable group in float32
    extra = None if name == "sgd" else 0.0 if capturable else _bias_correction_error(3)

    # the port writes after two steps; JAX restores it and steps
    for step in (0, 1):
        port.step(_grads(port.model, step), step)
    path = str(tmp_path / "port_state.ckpt")
    port.save(path, 2)
    before = port.params()
    target = ref.init(params0)
    params, state, epoch = jax_checkpoints.load_train_state(path, target)
    assert epoch == 1
    want, got = _leaves(target), _leaves(state)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (p, w), (_, g) in zip(want, got):
        assert np.asarray(g).dtype == np.asarray(w).dtype, p
        assert np.shape(g) == np.shape(w), p
    counts = [int(np.asarray(v)) for p, v in got if p[-1].key == "count"]
    assert counts == ([2, 2] if name == "adamw" and onecycle else [2] if onecycle or
                      name == "adamw" else [])
    # the moments / trace are the port's, in the JAX tree
    slot = {"adamw": ("exp_avg", "mu"), "sgd": ("momentum_buffer", "trace")}[name]
    inner = serialization.to_state_dict(state)
    inner = inner["inner_states"]["train"]["inner_state"] if mode else inner
    sd = {n: torch.zeros(v.shape) for n, v in port.model.state_dict().items()}
    sd.update({n: port.opt.state[p][slot[0]] for n, p in port.model.named_parameters()
               if p.requires_grad})
    mine = params_to_jax(sd, "small")
    for p, v in jax.tree_util.tree_flatten_with_path(inner["0"][slot[1]])[0]:
        node = mine
        for k in p:
            node = node[k.key]
        np.testing.assert_array_equal(np.asarray(v), node, err_msg=str(p))
    g3 = _grads(port.model, 2)
    port.step(g3, 2)
    new, _ = ref.update(jax.tree.map(jnp.asarray, params), state, g3)
    _within_one_ulp(port.params(), new, before, port.schedule(2), extra, "next step")

    # JAX writes after two updates; a fresh port run resumes it and steps
    params, state = params0, ref.init(params0)
    for step in (0, 1):
        params, state = ref.update(params, state, _grads(port.model, step))
    path = str(tmp_path / "jax_state.ckpt")
    jax_checkpoints.save_train_state(path, params, state, 3)
    port = _Port(net, mode, name, onecycle, capturable)
    sd, opt_state, epoch = checkpoints.load_train_state(path, "small")
    assert epoch == 3 and "optimizer" not in opt_state
    port.model.load_state_dict(sd, strict=True)
    step = checkpoints.restore_optimizer(port.opt, port.names, opt_state,
                                         port.model.state_dict(), "small")
    # SGD under the plateau holds no count: its rate does not follow one
    assert step == (0 if name == "sgd" and not onecycle else 2)
    assert len(port.opt.state) == len(port.names)
    if name == "adamw":
        assert all(s["step"].dtype == torch.float32 and float(s["step"]) == 2
                   for s in port.opt.state.values())
    before = port.params()
    port.step(g3, 2)
    new, _ = ref.update(params, state, g3)
    _within_one_ulp(port.params(), new, before, port.schedule(2), extra, "resumed step")


def test_restore_refuses_another_optimizers_state(tmp_path):
    port = _Port("2D", None, "sgd", True)
    port.step(_grads(port.model, 0), 0)
    path = str(tmp_path / "train_state.ckpt")
    port.save(path, 1)
    other = _Port("2D", None, "adamw", True)
    _, opt_state, _ = checkpoints.load_train_state(path, "small")
    with pytest.raises(ValueError, match="SGD"):
        checkpoints.restore_optimizer(other.opt, other.names, opt_state,
                                      other.model.state_dict(), "small")
