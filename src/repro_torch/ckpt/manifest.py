"""A MessagePack writer and reader for checkpoint manifests.

The manifest holds dicts, lists, str, int, float, bool and None, and these
functions write them byte for byte as ``msgpack.packb`` does by default
(the smallest int encoding, floats as float64, str with the str8 form,
tuples as arrays, dict keys in insertion order) and read them back as
``msgpack.unpackb`` does (arrays as lists), so the port needs no
``msgpack`` wheel and its manifests read in the JAX package and back.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

__all__ = ["packb", "unpackb"]


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` (``(code, struct format, limit)``) that holds ``n``."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in codes:
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too large for MessagePack")


def _int(out: bytearray, x: int) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out += struct.pack(">b", x)
    elif x >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if x < limit:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} too large for MessagePack")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31),
                                 (0xD3, ">q", 1 << 63)):
            if x >= -limit:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} too small for MessagePack")


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _int(out, int(obj))
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, ((0xD9, ">B", 1 << 8),
                                        (0xDA, ">H", 1 << 16),
                                        (0xDB, ">I", 1 << 32)))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, ((0xDC, ">H", 1 << 16),
                                        (0xDD, ">I", 1 << 32)))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, ((0xDE, ">H", 1 << 16),
                                        (0xDF, ">I", 1 << 32)))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} object")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}


def _read(buf: bytes, pos: int, fmt: str) -> Tuple[Any, int]:
    size = struct.calcsize(fmt)
    return struct.unpack_from(fmt, buf, pos)[0], pos + size


def _unpack(buf: bytes, pos: int) -> Tuple[Any, int]:
    code = buf[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _FIXED:
        return _read(buf, pos, _FIXED[code])
    if 0xA0 <= code <= 0xBF or code in _STR:
        n, pos = ((code & 0x1F, pos) if code <= 0xBF
                  else _read(buf, pos, _STR[code]))
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if 0x90 <= code <= 0x9F or code in _ARRAY:
        n, pos = ((code & 0x0F, pos) if code <= 0x9F
                  else _read(buf, pos, _ARRAY[code]))
        items = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            items.append(v)
        return items, pos
    if 0x80 <= code <= 0x8F or code in _MAP:
        n, pos = ((code & 0x0F, pos) if code <= 0x8F
                  else _read(buf, pos, _MAP[code]))
        out = {}
        for _ in range(n):
            k, pos = _unpack(buf, pos)
            out[k], pos = _unpack(buf, pos)
        return out, pos
    raise ValueError(f"unsupported MessagePack type 0x{code:02x}")


def unpackb(buf: bytes) -> Any:
    obj, pos = _unpack(bytes(buf), 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} extra bytes after the manifest")
    return obj
