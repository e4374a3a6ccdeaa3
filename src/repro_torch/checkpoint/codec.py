"""The subset of MessagePack that checkpoint manifests use, so the port
reads and writes the reference's ``manifest.msgpack`` without the
``msgpack`` package.

Types: map (dict, string keys), array (list or tuple; decoded as list),
str (UTF-8), int (-2**63 .. 2**64-1), float (float64), bool and nil.
``packb`` picks the smallest format for each value, as ``msgpack.packb``
does with its defaults, so the bytes are the package's.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 2 ** 8:
            out += bytes((0xD9, n))
        elif n < 2 ** 16:
            out.append(0xDA)
            out += struct.pack(">H", n)
        else:
            out.append(0xDB)
            out += struct.pack(">I", n)
        out += b
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 0xDC, 0xDD, out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 0xDE, 0xDF, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _header(n: int, fix: int, b16: int, b32: int, out: bytearray) -> None:
    if n < 16:
        out.append(fix | n)
    elif n < 2 ** 16:
        out.append(b16)
        out += struct.pack(">H", n)
    else:
        out.append(b32)
        out += struct.pack(">I", n)


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 2 ** 8), (0xCD, ">H", 2 ** 16),
                               (0xCE, ">I", 2 ** 32), (0xCF, ">Q", 2 ** 64)):
            if v < top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError("Integer value out of range")
    else:
        for code, fmt, low in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                               (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError("Integer value out of range")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCB: ">d"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",          # str
        0xDC: ">H", 0xDD: ">I",                      # array
        0xDE: ">H", 0xDF: ">I"}                      # map


def _unpack(b: bytes, i: int) -> Tuple[Any, int]:
    c = b[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if c == 0xC0:
        return None, i
    if c in (0xC2, 0xC3):
        return c == 0xC3, i
    if c in _FIXED:
        fmt = _FIXED[c]
        n = struct.calcsize(fmt)
        return struct.unpack_from(fmt, b, i)[0], i + n
    if 0xA0 <= c < 0xC0:
        n, kind = c & 0x1F, "str"
    elif 0x90 <= c < 0xA0:
        n, kind = c & 0x0F, "array"
    elif 0x80 <= c < 0x90:
        n, kind = c & 0x0F, "map"
    elif c in _LEN:
        fmt = _LEN[c]
        n = struct.unpack_from(fmt, b, i)[0]
        i += struct.calcsize(fmt)
        kind = ("str" if c in (0xD9, 0xDA, 0xDB) else
                "array" if c in (0xDC, 0xDD) else "map")
    else:
        raise ValueError(f"unsupported MessagePack type byte 0x{c:02x}")
    if kind == "str":
        return b[i:i + n].decode("utf-8"), i + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, i = _unpack(b, i)
            out.append(v)
        return out, i
    d = {}
    for _ in range(n):
        k, i = _unpack(b, i)
        v, i = _unpack(b, i)
        d[k] = v
    return d, i


def unpackb(data: bytes) -> Any:
    obj, end = _unpack(bytes(data), 0)
    if end != len(data):
        raise ValueError(f"extra data after the object ({len(data) - end} "
                         f"bytes)")
    return obj
