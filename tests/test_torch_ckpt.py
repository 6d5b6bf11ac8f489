"""The port's checkpoint reader and weight bridge against the JAX package.

The port reads flax ``.ckpt`` files with its own msgpack decoder; these
tests hold it leaf for leaf (bit-equal) to ``flax.serialization`` on the
committed MonkeyHand checkpoints, hold ``params_from_jax`` to the JAX
package's ``weights_io.*_params_to_torch`` exporters, and load both into the
port's modules with ``strict=True``.
"""

import pathlib

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from jarvis_hybridnet_torch.models.efficienttrack import EfficientTrackBackbone
from jarvis_hybridnet_torch.models.hybridnet import HybridNetBackbone
from jarvis_hybridnet_torch.models.weights import params_from_jax
from jarvis_hybridnet_torch.utils import ckpt_io
from jarvis_hybridnet_tpu.models import weights_io

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
CKPTS = ["CenterDetect", "KeypointDetect", "HybridNet"]


def _leaves(tree):
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _reference_sd(name, tree):
    if name == "HybridNet":
        return weights_io.hybridnet_params_to_torch(tree, "small")
    return weights_io.efficienttrack_params_to_torch(tree, "small")


def _port_module(name):
    if name == "HybridNet":
        return HybridNetBackbone(23, "small", 144, 2)
    return EfficientTrackBackbone("small", 1 if name == "CenterDetect" else 23)


@pytest.mark.parametrize("name", CKPTS)
def test_reader_matches_flax_bit_for_bit(name):
    data = (TRAINED / f"{name}_final.ckpt").read_bytes()
    ref = _leaves(serialization.msgpack_restore(data))
    got = _leaves(ckpt_io.read_ckpt(str(TRAINED / f"{name}_final.ckpt")))
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == np.asarray(v).tobytes(), k


def test_reader_decodes_flax_ext_types():
    """ndarrays of several dtypes (bfloat16 too), numpy scalars, complex,
    nested maps and plain msgpack scalars, as flax writes them."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "i8": np.arange(-5, 5, dtype=np.int8),
        "u16": np.arange(7, dtype=np.uint16).reshape(7, 1),
        "f64": np.float64(2.5),
        "bf16": jnp.asarray(rng.standard_normal(5), jnp.bfloat16),
        "scalar": np.int32(-7),
        "cplx": 1.5 - 2.0j,
        "nested": {"empty": np.zeros((0, 3), np.float32), "b": True, "n": None,
                   "s": "text", "big": 2 ** 40, "neg": -(2 ** 33), "f": 0.125},
    }
    data = serialization.msgpack_serialize(tree)
    ref = serialization.msgpack_restore(data)
    got = ckpt_io.unpackb(data)
    assert got["nested"]["s"] == "text" and got["nested"]["b"] is True
    assert got["nested"]["n"] is None and got["nested"]["big"] == 2 ** 40
    assert got["nested"]["neg"] == -(2 ** 33) and got["nested"]["f"] == 0.125
    assert got["cplx"] == ref["cplx"]
    assert got["scalar"] == ref["scalar"] and got["scalar"].dtype == np.int32
    assert got["f64"] == ref["f64"]
    for k in ("f32", "i8", "u16"):
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k])
    assert got["nested"]["empty"].shape == (0, 3)
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf16"].float().numpy(),
                                  np.asarray(ref["bf16"], np.float32))
    # a string map key of every msgpack width the decoder handles
    assert ckpt_io.unpackb(msgpack.packb({"k" * 40: 1, "x" * 300: [1, 2]})) == {
        "k" * 40: 1, "x" * 300: [1, 2]}


@pytest.mark.parametrize("name", CKPTS)
def test_params_from_jax_matches_weights_io(name):
    tree = serialization.msgpack_restore((TRAINED / f"{name}_final.ckpt").read_bytes())
    ref = _reference_sd(name, tree)
    got = params_from_jax(ckpt_io.read_ckpt(str(TRAINED / f"{name}_final.ckpt")), "small")
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)


@pytest.mark.parametrize("name", CKPTS)
def test_port_modules_load_both_strictly(name):
    tree = serialization.msgpack_restore((TRAINED / f"{name}_final.ckpt").read_bytes())
    ref = {k: torch.from_numpy(np.array(v, np.float32))
           for k, v in _reference_sd(name, tree).items()}
    for sd in (ref, params_from_jax(ckpt_io.read_ckpt(str(TRAINED / f"{name}_final.ckpt")),
                                    "small")):
        module = _port_module(name)
        missing, unexpected = module.load_state_dict(sd, strict=True)
        assert not missing and not unexpected
