"""A small msgpack reader and writer for the JAX package's checkpoints (Flax
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


def _pack_header(out: bytearray, n: int, fix: tuple | None, codes: tuple) -> None:
    """A length or count: the fix form (max, base) where there is one and n
    fits, else the 8-, 16- or 32-bit form (codes[0] None: no 8-bit form)."""
    if fix is not None and n <= fix[0]:
        out.append(fix[1] | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v > 0:
        for code, fmt, top in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                               (0xCE, ">BI", 0xFFFFFFFF), (0xCF, ">BQ", 2**64 - 1)):
            if v <= top:
                out += struct.pack(fmt, code, v)
                return
        raise ValueError(f"msgpack: integer {v} out of range")
    else:
        for code, fmt, low in ((0xD0, ">Bb", -2**7), (0xD1, ">Bh", -2**15),
                               (0xD2, ">Bi", -2**31), (0xD3, ">Bq", -2**63)):
            if v >= low:
                out += struct.pack(fmt, code, v)
                return
        raise ValueError(f"msgpack: integer {v} out of range")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out += struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC8, n)
    else:
        out += struct.pack(">BI", 0xC9, n)
    out += struct.pack(">b", code)
    out += data


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    """Flax's ndarray payload: msgpack of (shape, dtype name, C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not supported")
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(out)


def _pack(out: bytearray, v) -> None:
    if v is None:
        out.append(0xC0)
    elif type(v) is bool:
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, np.ndarray):
        if v.nbytes > 2**30:
            raise ValueError("msgpack: arrays past 2**30 bytes would be chunked; not supported")
        _pack_ext(out, EXT_NDARRAY, _ndarray_to_bytes(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(v)))
    elif type(v) is int:
        _pack_int(out, v)
    elif type(v) is float:
        out += struct.pack(">Bd", 0xCB, v)
    elif type(v) is str:
        raw = v.encode("utf-8")
        _pack_header(out, len(raw), (31, 0xA0), (0xD9, 0xDA, 0xDB))
        out += raw
    elif type(v) is bytes:
        _pack_header(out, len(v), None, (0xC4, 0xC5, 0xC6))
        out += v
    elif type(v) in (list, tuple):
        _pack_header(out, len(v), (15, 0x90), (None, 0xDC, 0xDD))
        for item in v:
            _pack(out, item)
    elif type(v) is dict:
        _pack_header(out, len(v), (15, 0x80), (None, 0xDE, 0xDF))
        for k in sorted(v):
            _pack(out, k)
            _pack(out, v[k])
    else:
        raise TypeError(f"msgpack: cannot serialize {type(v).__name__}")


def msgpack_serialize(tree) -> bytes:
    """The Flax msgpack bytes of a tree of dicts with string keys, lists,
    tuples, Python scalars, strings, numpy arrays and numpy scalars."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def save(path: str | Path, tree) -> None:
    """Write ``msgpack_serialize(tree)`` to ``path``."""
    Path(path).write_bytes(msgpack_serialize(tree))
