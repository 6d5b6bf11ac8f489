"""Reader and writer of flax ``.ckpt`` files with no msgpack or flax
dependency.

The JAX package writes checkpoints with ``flax.serialization.to_bytes``
(``jarvis_hybridnet_tpu/training/checkpoints.py:36``): a msgpack map of maps
whose leaves are msgpack *ext* records. This module decodes the subset of
msgpack that flax writes:

  * nil, bool, ints, float32/64, str, bin, arrays and maps;
  * ext type 1, an ndarray: the payload is itself msgpack of
    ``(shape, dtype_name, raw_bytes)`` in C order;
  * ext type 2, a Python complex: msgpack of ``(real, imag)``;
  * ext type 3, a numpy scalar: an ndarray payload of shape ``()``;
  * flax's chunked arrays (``__msgpack_chunked_array__``, used for leaves
    above 1 GiB), joined back into one array.

Leaves come back as writable numpy arrays; ``bfloat16`` leaves, which numpy
cannot hold, come back as ``torch.bfloat16`` tensors.

:func:`write_ckpt` writes the same subset the other way (maps with string
keys, ints, floats, strings, bytes, lists, and numpy arrays or CPU tensors
as ext type 1 ndarrays), as ``flax.serialization.to_bytes`` writes a state
dict: the JAX package's ``load_checkpoint`` reads it.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack(">B"))),
            0xC5: lambda: bytes(self.take(self.unpack(">H"))),
            0xC6: lambda: bytes(self.take(self.unpack(">I"))),
            0xC7: lambda: self.ext(self.unpack(">B")),
            0xC8: lambda: self.ext(self.unpack(">H")),
            0xC9: lambda: self.ext(self.unpack(">I")),
            0xCA: lambda: self.unpack(">f"),
            0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack(">B"),
            0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"),
            0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"),
            0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"),
            0xD3: lambda: self.unpack(">q"),
            0xD4: lambda: self.ext(1),
            0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4),
            0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: self.str(self.unpack(">B")),
            0xDA: lambda: self.str(self.unpack(">H")),
            0xDB: lambda: self.str(self.unpack(">I")),
            0xDC: lambda: self.array(self.unpack(">H")),
            0xDD: lambda: self.array(self.unpack(">I")),
            0xDE: lambda: self.map(self.unpack(">H")),
            0xDF: lambda: self.map(self.unpack(">I")),
        }
        if b not in simple:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        return simple[b]()

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            re, im = unpackb(payload)
            return complex(re, im)
        raise ValueError(f"unsupported msgpack ext type {code}")


def _ndarray(payload: bytes):
    shape, dtype_name, raw = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    shape = tuple(int(s) for s in shape)
    if dtype_name == "bfloat16":
        import torch

        bits = np.frombuffer(raw, np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(raw, np.dtype(dtype_name)).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (the flax subset, see module docstring)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate([np.ravel(c) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_ckpt(path: str) -> dict:
    """Nested dict of the parameter tree stored in a flax ``.ckpt`` file."""
    with open(path, "rb") as f:
        return _unchunk(unpackb(f.read()))


def _pack_len(out: bytearray, n: int, small: tuple[int, int] | None, codes: tuple[int, ...]):
    """A length header: ``small`` = (base, limit) of the fix form, then the
    8 / 16 / 32-bit forms (a code of 0 means the form does not exist)."""
    if small is not None and n < small[1]:
        out.append(small[0] | n)
    elif codes[0] and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _ndarray_payload(a) -> bytes:
    if hasattr(a, "detach"):  # a torch tensor
        import torch

        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return packb([list(t.shape), "bfloat16", t.view(torch.uint16).numpy().tobytes("C")])
        a = t.numpy()
    a = np.asarray(a)
    return packb([list(a.shape), a.dtype.name, a.tobytes("C")])


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(obj)
        elif -32 <= obj < 0:
            out.append(obj & 0xFF)
        elif obj >= 0:
            out += struct.pack(">BQ", 0xCF, obj)
        else:
            out += struct.pack(">Bq", 0xD3, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), (0x80, 16), (0, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), (0x90, 16), (0, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, np.ndarray) or hasattr(obj, "detach"):
        payload = _ndarray_payload(obj)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(payload) in fixext:
            out.append(fixext[len(payload)])
        else:
            _pack_len(out, len(payload), None, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _EXT_NDARRAY)
        out += payload
    elif isinstance(obj, np.generic):
        _pack(np.asarray(obj), out)
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to a .ckpt")


def packb(obj: Any) -> bytes:
    """Encode one object as msgpack (the subset :func:`unpackb` reads)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def write_ckpt(path: str, tree: dict) -> None:
    """Write a nested dict of arrays as a flax ``.ckpt`` file."""
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(packb(tree))
