"""A decoder of the msgpack that ``flax.serialization.to_bytes`` writes, in
pure Python and numpy: the JAX package's checkpoints
(``multi_task_breast_cancer_tpu/train/checkpoint.py``) read on a machine with
neither flax nor ``msgpack``.

What flax writes, and what comes back:

- maps, arrays, strings, bin, ints, floats, nil and bools (arrays come back as
  lists, bin as ``bytes``);
- flax's ext types: ``ndarray`` (1) and ``npscalar`` (3), whose payload is
  itself msgpack of ``(shape, dtype name, C-order buffer)``, and
  ``native_complex`` (2), msgpack of ``(real, imag)``;
- arrays over 2**30 bytes, which flax splits into a
  ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`` map,
  joined again.

Tuples, lists and namedtuples reach the file as maps keyed ``"0"``,
``"1"``… or by field name (flax's state dicts); they stay maps here.
``bfloat16`` buffers are widened to float32 exactly (numpy has no bfloat16).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY, EXT_NATIVE_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (wanted {n} more)")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)


def _ext(code: int, payload: bytes):
    if code in (EXT_NDARRAY, EXT_NPSCALAR):
        shape, dtype, buf = unpackb(payload)
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        if dtype == "bfloat16":
            bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(buf, np.dtype(dtype)).copy()
        arr = arr.reshape(shape)
        return arr[()] if code == EXT_NPSCALAR else arr
    if code == EXT_NATIVE_COMPLEX:
        real, imag = unpackb(payload)
        return complex(real, imag)
    raise ValueError(f"msgpack: ext type {code} is not one flax writes")


def _read(r: _Reader) -> Any:
    b = r.uint(1)
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return r.take(b & 0x1F).decode()
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in (0xC4, 0xC5, 0xC6):
        return r.take(r.uint(1 << (b - 0xC4)))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.uint(1 << (b - 0xC7))
        code = r.sint(1)
        return _ext(code, r.take(n))
    if b == 0xCA:
        return struct.unpack(">f", r.take(4))[0]
    if b == 0xCB:
        return struct.unpack(">d", r.take(8))[0]
    if 0xCC <= b <= 0xCF:
        return r.uint(1 << (b - 0xCC))
    if 0xD0 <= b <= 0xD3:
        return r.sint(1 << (b - 0xD0))
    if 0xD4 <= b <= 0xD8:
        code = r.sint(1)
        return _ext(code, r.take(1 << (b - 0xD4)))
    if 0xD9 <= b <= 0xDB:
        return r.take(r.uint(1 << (b - 0xD9))).decode()
    if b in (0xDC, 0xDD):
        return [_read(r) for _ in range(r.uint(2 if b == 0xDC else 4))]
    if b in (0xDE, 0xDF):
        return _map(r, r.uint(2 if b == 0xDE else 4))
    raise ValueError(f"msgpack: byte 0x{b:02x} at {r.pos - 1} starts no object")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        out[key] = _read(r)
    return out


def unpackb(data: bytes) -> Any:
    """One msgpack object from ``data``; trailing bytes raise."""
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes after the object")
    return obj


def _unchunk(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if node.get(_CHUNKED) is True:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def msgpack_restore(data: bytes) -> Any:
    """The state dict ``flax.serialization.msgpack_restore`` would return:
    nested dicts with numpy leaves, chunked arrays joined."""
    return _unchunk(unpackb(data))
