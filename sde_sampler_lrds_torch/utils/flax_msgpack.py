"""A small msgpack reader for the JAX package's checkpoints (Flax
``serialization.msgpack_serialize`` / ``to_bytes`` files), in pure Python
with numpy: the NICE flows under ``data/`` and the EBM parameters the MNIST
EBM curve writes.

It decodes the msgpack types those files use (maps, arrays, strings,
binaries, integers, floats, bools and nil) and Flax's two numpy extension
types: code 1, an ndarray, whose payload is itself a msgpack (shape, dtype
name, C-order bytes) triple (``serialization._ndarray_to_bytes``), and code
3, a numpy scalar with the same payload. Flax splits arrays past 2**30 bytes
into chunks; no file of this repository holds one, and the reader refuses
them.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, blob: bytes):
        self.buf = memoryview(blob)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (needs {n} more)")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
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
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= b <= 0xC6:
            return bytes(self.take(self.unpack(sizes[b - 0xC4])))
        if 0xD9 <= b <= 0xDB:
            return str(self.take(self.unpack(sizes[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(sizes[b - 0xDC + 1]))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(sizes[b - 0xDE + 1]))
        if 0xC7 <= b <= 0xC9:
            return self.ext(self.unpack(sizes[b - 0xC7]))
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at byte {self.pos - 1}")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if _CHUNKED in out:
            raise ValueError("msgpack: chunked arrays (past 2**30 bytes) are not supported")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported extension type {code}")
        arr = _ndarray_from_bytes(data)
        return arr if code == EXT_NDARRAY else arr[()]


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    """Flax's ndarray payload: a msgpack (shape, dtype name, C-order bytes)."""
    shape, dtype_name, raw = _Reader(data).read()
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape, order="C").copy()


def msgpack_restore(blob: bytes):
    """The nested dicts, lists, scalars and numpy arrays of a Flax msgpack
    blob, as ``flax.serialization.msgpack_restore`` returns them."""
    reader = _Reader(blob)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} trailing bytes")
    return out


def load(path: str | Path):
    """``msgpack_restore`` of a file."""
    return msgpack_restore(Path(path).read_bytes())
