"""flax-msgpack checkpoints, read in pure Python.

Counterpart of ``load_checkpoint`` (``pointcept_keypointdetection_tpu/utils/
checkpoint.py:30-32``), which is ``flax.serialization.msgpack_restore``: the
JAX package writes its checkpoints (``*.ckpt``) as one msgpack object, a map
of nested maps whose leaves are arrays and Python scalars.  This module
decodes that format itself, with ``struct`` and numpy, so that the port reads
a checkpoint on a machine without the ``msgpack`` package.

What ``load_checkpoint`` returns is what ``msgpack_restore`` returns:

* maps as dicts (a key that arrives as bin is decoded as UTF-8 text), arrays
  as lists, str, bin as bytes, ints, floats, None and bools;
* flax's ext type 1 (an ndarray: its payload is itself msgpack, ``(shape,
  dtype name, C-order buffer)``) as a numpy array that owns a copy of its
  bytes; ext type 3 (an npscalar, written as a 0-d ndarray) as its numpy
  scalar; ext type 2 (a native complex, ``(real, imag)``) as a ``complex``;
* leaves flax split into ``{"__msgpack_chunked_array__": True, "shape":
  {...}, "chunks": {...}}`` (over 2^30 bytes) joined back into one array, as
  flax's ``_unchunk`` does.

Dtypes: float16/32/64, int8-64, uint8-64 and bool.  numpy has no bfloat16
(flax reads it as ``ml_dtypes.bfloat16``), so a bfloat16 leaf comes back as a
``torch.bfloat16`` tensor over its bits (an npscalar of it as a 0-d tensor).
Any other ext type or dtype raises ``CheckpointError`` naming the leaf's
path.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Union

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
_DTYPES = {name: np.dtype(name) for name in (
    "float16", "float32", "float64", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
    "bool")}
# fixed-size scalars: type byte -> struct format (big-endian, as msgpack writes them)
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
            0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
# variable-size items: type byte -> (kind, struct format of the length)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"), 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"),
          0xC9: ("ext", ">I"), 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"), 0xDC: ("array", ">H"),
          0xDD: ("array", ">I"), 0xDE: ("map", ">H"), 0xDF: ("map", ">I")}

Leaf = Union[np.ndarray, np.generic, torch.Tensor, complex, int, float, str, bytes, bool, None]


class CheckpointError(ValueError):
    """A checkpoint this reader does not take: malformed, or an ext type or dtype flax does not write."""


class _Decoder:
    def __init__(self, data: bytes, where: str):
        self.data = memoryview(data)
        self.pos = 0
        self.where = where

    def fail(self, path: List[str], msg: str):
        raise CheckpointError(f"{self.where}: {'/'.join(path) or '<root>'}: {msg}")

    def take(self, n: int, path: List[str]) -> memoryview:
        if self.pos + n > len(self.data):
            self.fail(path, f"truncated: {n} bytes wanted at byte {self.pos} of {len(self.data)}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, path: List[str]):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt), path))[0]

    def value(self, path: List[str]) -> Any:
        b = self.take(1, path)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F, path)
        if b <= 0x9F:
            return [self.value(path + [str(i)]) for i in range(b & 0x0F)]
        if b <= 0xBF:
            return self.text(b & 0x1F, path)
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in _SCALARS:
            return self.unpack(_SCALARS[b], path)
        if b in _FIXEXT:
            code = self.unpack(">b", path)
            return self.ext(code, bytes(self.take(_FIXEXT[b], path)), path)
        if b not in _SIZED:
            self.fail(path, f"byte 0x{b:02x} at {self.pos - 1} is no msgpack type")
        kind, fmt = _SIZED[b]
        n = self.unpack(fmt, path)
        if kind == "bin":
            return bytes(self.take(n, path))
        if kind == "str":
            return self.text(n, path)
        if kind == "array":
            return [self.value(path + [str(i)]) for i in range(n)]
        if kind == "map":
            return self.map(n, path)
        code = self.unpack(">b", path)
        return self.ext(code, bytes(self.take(n, path)), path)

    def text(self, n: int, path: List[str]) -> str:
        return str(self.take(n, path), "utf-8")

    def map(self, n: int, path: List[str]) -> Dict:
        out = {}
        for _ in range(n):
            key = self.value(path)
            if isinstance(key, bytes):
                key = key.decode("utf-8")
            out[key] = self.value(path + [str(key)])
        if CHUNKED in out:
            return _unchunk(out, self, path)
        return out

    def ext(self, code: int, payload: bytes, path: List[str]) -> Leaf:
        if code == _EXT_COMPLEX:
            real, imag = _Decoder(payload, self.where).whole(path)
            return complex(real, imag)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            self.fail(path, f"msgpack ext type {code} is not one of flax's (1 ndarray, 2 complex, 3 npscalar)")
        shape, name, buffer = _Decoder(payload, self.where).whole(path)
        name = name.decode("ascii") if isinstance(name, bytes) else name
        arr = _array(shape, name, buffer, self, path)
        return arr[()] if code == _EXT_NPSCALAR else arr

    def whole(self, path: List[str]) -> Any:
        out = self.value(path)
        if self.pos != len(self.data):
            self.fail(path, f"{len(self.data) - self.pos} bytes after the end of the object")
        return out


def _array(shape, name: str, buffer, dec: _Decoder, path: List[str]) -> Union[np.ndarray, torch.Tensor]:
    """A leaf's array, its own copy of the bytes: numpy, or for bfloat16 a torch tensor."""
    if isinstance(buffer, str):
        buffer = buffer.encode("latin-1")
    shape = tuple(int(s) for s in shape)
    dtype = np.dtype(np.uint16) if name == "bfloat16" else _DTYPES.get(name)
    if dtype is None:
        dec.fail(path, f"dtype {name!r} is not one this reader takes ({', '.join(_DTYPES)}, bfloat16)")
    if len(buffer) != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
        dec.fail(path, f"{len(buffer)} bytes do not hold {name} {list(shape)}")
    arr = np.frombuffer(buffer, dtype).reshape(shape).copy()
    return torch.from_numpy(arr).view(torch.bfloat16) if name == "bfloat16" else arr


def _unchunk(data: Dict, dec: _Decoder, path: List[str]) -> Union[np.ndarray, torch.Tensor]:
    """flax's ``_unchunk``: the chunks, in order, joined and reshaped."""
    try:
        shape = tuple(data["shape"][str(i)] for i in range(len(data["shape"])))
        chunks = [data["chunks"][str(i)] for i in range(len(data["chunks"]))]
    except (KeyError, TypeError) as e:
        dec.fail(path, f"a chunked leaf without its shape or chunks ({e!r})")
    if all(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def restore(data: bytes, where: str = "<bytes>") -> Any:
    """``flax.serialization.msgpack_restore`` of ``data``; ``where`` names it in errors."""
    return _Decoder(data, where).whole([])


def load_checkpoint(path: str) -> Any:
    """The tree of the flax-msgpack file at ``path``: nested dicts of numpy arrays
    (bfloat16 as torch tensors) and Python scalars."""
    with open(path, "rb") as f:
        return restore(f.read(), str(path))
