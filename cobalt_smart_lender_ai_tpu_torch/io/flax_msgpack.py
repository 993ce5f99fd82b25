"""flax's msgpack byte format for a tree of arrays, written and read without
flax or msgpack.

`pack_tree` gives the bytes of ``flax.serialization.msgpack_serialize`` for
a parameter tree: dicts with string keys (written in sorted key order, as
flax's tree copy leaves them) over numpy arrays. An array is msgpack
extension type 1 whose payload is the msgpack array ``(shape, dtype name,
C-order bytes)``. `unpack_tree` reads that subset back
(``msgpack_restore``'s result). flax splits arrays over 2**30 bytes into
chunks; neither side here does.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

__all__ = ["pack_tree", "unpack_tree"]

_EXT_NDARRAY = 1
_MAX_ARRAY_BYTES = 2**30


def _length(out: bytearray, n: int, fix: tuple[int, int] | None, codes: tuple[int, ...]) -> None:
    """A length header: the fix form (base, limit) if it fits, else the
    8/16/32-bit form among ``codes`` (None where a width has none)."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} out of range")


def _pack_uint(out: bytearray, v: int) -> None:
    if v < 0x80:
        out.append(v)
        return
    for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                             (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
        if v < limit:
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"int {v} out of msgpack's range")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _length(out, n, None, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += payload


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    if arr.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError(f"array of {arr.nbytes} bytes: flax would chunk it, which this codec does not")
    out = bytearray()
    _pack(out, (tuple(int(d) for d in arr.shape), arr.dtype.name, arr.tobytes("C")))
    return bytes(out)


def _pack(out: bytearray, v: Any) -> None:
    if isinstance(v, int) and not isinstance(v, bool) and v >= 0:
        _pack_uint(out, v)
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _length(out, len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(v, bytes):
        _length(out, len(v), None, (0xC4, 0xC5, 0xC6))
        out += v
    elif isinstance(v, dict):
        _length(out, len(v), (0x80, 16), (None, 0xDE, 0xDF))
        for key in sorted(v):
            _pack(out, key)
            _pack(out, v[key])
    elif isinstance(v, (list, tuple)):
        _length(out, len(v), (0x90, 16), (None, 0xDC, 0xDD))
        for item in v:
            _pack(out, item)
    elif isinstance(v, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(v))
    else:
        raise TypeError(f"cannot serialize {type(v).__name__}")


def pack_tree(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``'s bytes."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = bytes(self.data[self.pos : self.pos + n])
        self.pos += n
        return chunk

    def num(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return self.take(self.num(sized[b]))
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
        if b in ints:
            return self.num(ints[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.take(self.num(strs[b])).decode("utf-8")
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.num(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.mapping(self.num(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in fixext or b in ext:
            n = fixext[b] if b in fixext else self.num(ext[b])
            code = self.num(">b")
            return self.extension(code, self.take(n))
        raise ValueError(f"msgpack byte 0x{b:02x} is outside the subset this codec reads")

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    @staticmethod
    def extension(code: int, payload: bytes) -> np.ndarray:
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack extension type {code} is not an ndarray")
        shape, dtype, buffer = _Reader(payload).value()
        return np.frombuffer(buffer, dtype=np.dtype(dtype)).reshape(shape).copy()


def unpack_tree(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore(data)``'s tree (writable numpy
    arrays)."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack tree")
    return tree
