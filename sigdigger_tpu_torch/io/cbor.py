"""Minimal deterministic CBOR (RFC 8949) codec (counterpart of
``sigdigger_tpu/io/cbor.py``: the same bytes for every value).

The suscan remote-analyzer protocol serializes its call payloads with a
compact CBOR subset (the suscan C sources are not present in the
reference tree; the serialization discipline here follows the public
CBOR standard).  This codec implements exactly the subset the wire
protocol needs, deterministically:

- unsigned / negative integers (shortest form),
- byte strings, UTF-8 text strings (definite length),
- arrays and maps (definite length),
- floats: float32 values encode as IEEE-754 single (0xfa), Python
  floats as double (0xfb),
- ``False`` / ``True`` / ``None`` simple values.

Determinism matters: the golden byte vectors in
``tests/test_suscan_wire.py`` and ``tests/test_torch_wire.py`` pin every
handshake/message encoding so any change to the wire image is an
intentional, reviewed diff.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_MAJOR_UINT = 0
_MAJOR_NINT = 1
_MAJOR_BYTES = 2
_MAJOR_TEXT = 3
_MAJOR_ARRAY = 4
_MAJOR_MAP = 5
_SIMPLE_FALSE = b"\xf4"
_SIMPLE_TRUE = b"\xf5"
_SIMPLE_NULL = b"\xf6"
_FLOAT32 = b"\xfa"
_FLOAT64 = b"\xfb"


def _head(major: int, arg: int) -> bytes:
    mb = major << 5
    if arg < 24:
        return bytes([mb | arg])
    if arg < 0x100:
        return bytes([mb | 24, arg])
    if arg < 0x10000:
        return bytes([mb | 25]) + struct.pack(">H", arg)
    if arg < 0x100000000:
        return bytes([mb | 26]) + struct.pack(">I", arg)
    return bytes([mb | 27]) + struct.pack(">Q", arg)


def encode(obj: Any) -> bytes:
    """Encode ``obj`` to canonical CBOR bytes."""
    out = bytearray()
    _encode_into(obj, out)
    return bytes(out)


_pack_d = struct.Struct(">d").pack


def _encode_into(obj: Any, out: bytearray) -> None:
    # the exact built-in types first (a live session's messages are
    # mostly these); any other type takes the isinstance chain, whose
    # order decides subclasses (bool before int, np.float64 as float)
    t = type(obj)
    if t is int:
        if 0 <= obj < 24:
            out.append(obj)
        elif obj >= 0:
            out += _head(_MAJOR_UINT, obj)
        else:
            out += _head(_MAJOR_NINT, -1 - obj)
    elif t is list or t is tuple:
        n = len(obj)
        if n < 24:
            out.append(0x80 | n)
        else:
            out += _head(_MAJOR_ARRAY, n)
        for item in obj:
            _encode_into(item, out)
    elif t is bytes:
        out += _head(_MAJOR_BYTES, len(obj))
        out += obj
    elif t is str:
        b = obj.encode("utf-8")
        out += _head(_MAJOR_TEXT, len(b))
        out += b
    elif t is float:
        out += _FLOAT64
        out += _pack_d(obj)
    elif t is dict:
        out += _head(_MAJOR_MAP, len(obj))
        for k, v in obj.items():
            _encode_into(k, out)
            _encode_into(v, out)
    else:
        _encode_other(obj, out)


def _encode_other(obj: Any, out: bytearray) -> None:
    if obj is None:
        out += _SIMPLE_NULL
    elif obj is True:
        out += _SIMPLE_TRUE
    elif obj is False:
        out += _SIMPLE_FALSE
    elif isinstance(obj, np.float32):
        out += _FLOAT32 + struct.pack(">f", float(obj))
    elif isinstance(obj, float):
        out += _FLOAT64 + struct.pack(">d", obj)
    elif isinstance(obj, (int, np.integer)):
        v = int(obj)
        if v >= 0:
            out += _head(_MAJOR_UINT, v)
        else:
            out += _head(_MAJOR_NINT, -1 - v)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out += _head(_MAJOR_BYTES, len(b)) + b
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out += _head(_MAJOR_TEXT, len(b)) + b
    elif isinstance(obj, (list, tuple)):
        out += _head(_MAJOR_ARRAY, len(obj))
        for item in obj:
            _encode_into(item, out)
    elif isinstance(obj, dict):
        out += _head(_MAJOR_MAP, len(obj))
        for k, v in obj.items():
            _encode_into(k, out)
            _encode_into(v, out)
    else:
        raise TypeError(f"CBOR: unsupported type {type(obj)!r}")


_unpack_h = struct.Struct(">H").unpack_from
_unpack_i = struct.Struct(">I").unpack_from
_unpack_q = struct.Struct(">Q").unpack_from
_unpack_f = struct.Struct(">f").unpack_from
_unpack_d = struct.Struct(">d").unpack_from
_ARG_WIDTH = {24: 1, 25: 2, 26: 4, 27: 8}


def _truncated() -> ValueError:
    return ValueError("CBOR: truncated input")


def _decode_at(buf: bytes, pos: int) -> tuple[Any, int]:
    """The item at ``buf[pos]`` and the position past it."""
    if pos >= len(buf):
        raise _truncated()
    ib = buf[pos]
    pos += 1
    major, info = ib >> 5, ib & 0x1F
    if major == 7:
        if info == 20:
            return False, pos
        if info == 21:
            return True, pos
        if info == 22:
            return None, pos
        if info == 26:
            if pos + 4 > len(buf):
                raise _truncated()
            return float(_unpack_f(buf, pos)[0]), pos + 4
        if info == 27:
            if pos + 8 > len(buf):
                raise _truncated()
            return _unpack_d(buf, pos)[0], pos + 8
        raise ValueError(f"CBOR: unsupported item 0x{ib:02x}")
    if major == 6:
        raise ValueError(f"CBOR: unsupported item 0x{ib:02x}")
    if info < 24:
        arg = info
    else:
        w = _ARG_WIDTH.get(info)
        if w is None:
            raise ValueError(f"CBOR: unsupported additional info {info}")
        if pos + w > len(buf):
            raise _truncated()
        arg = (buf[pos] if w == 1 else _unpack_h(buf, pos)[0] if w == 2
               else _unpack_i(buf, pos)[0] if w == 4
               else _unpack_q(buf, pos)[0])
        pos += w
    if major == _MAJOR_UINT:
        return arg, pos
    if major == _MAJOR_NINT:
        return -1 - arg, pos
    if major == _MAJOR_BYTES or major == _MAJOR_TEXT:
        end = pos + arg
        if end > len(buf):
            raise _truncated()
        b = buf[pos:end]
        return (b if major == _MAJOR_BYTES else b.decode("utf-8")), end
    if major == _MAJOR_ARRAY:
        items = []
        for _ in range(arg):
            item, pos = _decode_at(buf, pos)
            items.append(item)
        return items, pos
    d = {}
    for _ in range(arg):
        k, pos = _decode_at(buf, pos)
        d[k], pos = _decode_at(buf, pos)
    return d, pos


def decode(buf: bytes) -> Any:
    """Decode a single CBOR item; trailing bytes are an error."""
    buf = bytes(buf)
    obj, pos = _decode_at(buf, 0)
    if pos != len(buf):
        raise ValueError(f"CBOR: {len(buf) - pos} trailing bytes")
    return obj
