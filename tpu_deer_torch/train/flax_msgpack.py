"""A reader of flax's msgpack serialization (`flax.serialization.to_bytes`,
the reference's `state.msgpack` checkpoints), in the port's own code: the
machine with the card has no `msgpack` package.

It decodes the msgpack format (https://github.com/msgpack/msgpack/blob/master/spec.md)
with flax's extension types: 1, an ndarray packed as (shape, dtype name,
C-order bytes); 2, a complex number packed as (real, imag); 3, a numpy
scalar packed as a 0-d ndarray. Arrays flax split into chunks (a dict with
"__msgpack_chunked_array__", "shape" and "chunks", for leaves over 2^30
bytes) are joined again. Strings decode as UTF-8 and bin as bytes, as
`msgpack.unpackb(raw=False)` gives them. numpy has no bfloat16: a bfloat16
array decodes as float32 holding the same values.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


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

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin
        if b in sizes:
            return bytes(self.take(self.unpack(sizes[b])))
        sizes = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}  # str
        if b in sizes:
            return str(self.take(self.unpack(sizes[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(fixext[b])))
        sizes = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext
        if b in sizes:
            n = self.unpack(sizes[b])
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    """One msgpack object from `data` (flax's extension types decoded)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype, buffer = unpackb(data)
    if dtype == "bfloat16":  # the high 16 bits of a float32
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype)).reshape(shape)


def _ext(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    raise ValueError(f"unknown msgpack extension type {code}")


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """The tree `flax.serialization.msgpack_restore` gives for `data`:
    nested dicts (flax's state dict) with numpy leaves."""
    return _unchunk(unpackb(data))
