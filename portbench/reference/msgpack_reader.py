"""A reader of flax's msgpack checkpoints in pure Python and numpy.

A frozen copy of the port's reader (``votenet_tpu_torch/utils/checkpoint.py``,
``_Reader``, ``_unchunk``, ``read_flax_msgpack``), so that the benchmark
loads the trained weights itself and hands the same tensors to the program
and to the reference.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

MAX_CHUNK_BYTES = 2**30


class _Reader:
    """A msgpack decoder over one bytes object (the subset flax writes)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (want {n} more)")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def value(self, raw: bool = False) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F, raw)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F, raw)
        if 0xA0 <= t <= 0xBF:
            return self.str(t & 0x1F, raw)
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}
        if t in sized:
            return self.take(self.unpack(sized[t]))
        if t in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: "B", 0xC8: "H", 0xC9: "I"}[t]))
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if t in scalars:
            return self.unpack(scalars[t])
        if 0xD4 <= t <= 0xD8:
            return self.ext(1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack({0xD9: "B", 0xDA: "H", 0xDB: "I"}[t]), raw)
        if t in (0xDC, 0xDD):
            return self.array(self.unpack("H" if t == 0xDC else "I"), raw)
        if t in (0xDE, 0xDF):
            return self.map(self.unpack("H" if t == 0xDE else "I"), raw)
        raise ValueError(f"msgpack: unknown type byte 0x{t:02x} at byte {self.pos - 1}")

    def str(self, n: int, raw: bool):
        b = self.take(n)
        return b if raw else b.decode("utf-8")

    def array(self, n: int, raw: bool) -> list:
        return [self.value(raw) for _ in range(n)]

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.value(raw)
            out[k] = self.value(raw)
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code not in (1, 3):
            raise ValueError(f"msgpack: flax ext type {code} is not read by the port")
        # flax decodes the nested triple with raw=True: the dtype name is bytes
        shape, dtype, buf = _Reader(data).value(raw=True)
        try:
            dt = np.dtype(dtype.decode())
        except TypeError as e:
            raise ValueError(f"msgpack: numpy has no dtype {dtype.decode()!r}") from e
        arr = np.frombuffer(buf, dtype=dt).reshape(shape, order="C")
        return arr if code == 1 else arr[()]


def _unchunk(tree):
    """Join the arrays flax split into chunks (``__msgpack_chunked_array__``)."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path: str) -> Any:
    """Decode a flax msgpack file into nested dicts of numpy arrays and
    Python scalars: what ``flax.serialization.msgpack_restore`` returns.
    Raises ValueError on bytes it cannot read (bfloat16 arrays among them:
    numpy has no such dtype)."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} trailing bytes in {path}")
    return _unchunk(tree)

