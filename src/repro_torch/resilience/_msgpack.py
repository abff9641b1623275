"""The msgpack subset the write-ahead log, the snapshot meta and the
config blob use, in pure Python.

``packb`` produces the bytes ``msgpack.packb`` produces under msgpack
≥ 1.0's defaults (``use_bin_type=True``), so a directory the port writes
is one the reference reads and the other way round: the WAL's digest
covers the packed body, and one byte off makes a log unreadable to the
other framework.  ``unpackb`` decodes what msgpack writes for the same
types (``raw=False``: str as str, bin as bytes, maps as dicts, arrays as
lists).

Types: nil, bool, int (every width, negative included), float (packed
as float64; a float32 is read), str and bin (8/16/32-bit lengths),
array and map (fix, 16- and 32-bit lengths).  Anything else raises
``TypeError``; tuples pack as arrays, as msgpack packs them.
"""
from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")


def _int(v: int, out: list) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(_B.pack(v))
        elif v <= 0xFF:
            out.append(b"\xcc" + _B.pack(v))
        elif v <= 0xFFFF:
            out.append(b"\xcd" + _H.pack(v))
        elif v <= 0xFFFFFFFF:
            out.append(b"\xce" + _I.pack(v))
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + _Q.pack(v))
        else:
            raise OverflowError(f"int {v} too large for msgpack")
    elif v >= -32:
        out.append(_b.pack(v))
    elif v >= -0x80:
        out.append(b"\xd0" + _b.pack(v))
    elif v >= -0x8000:
        out.append(b"\xd1" + _h.pack(v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + _i.pack(v))
    elif v >= -0x8000000000000000:
        out.append(b"\xd3" + _q.pack(v))
    else:
        raise OverflowError(f"int {v} too small for msgpack")


def _len_header(n: int, fix_tag: int | None, fix_max: int, tags: tuple,
                out: list) -> None:
    """The length prefix of a str / bin / array / map: its fix form when
    there is one and n fits, else the 8- (str and bin only), 16- or
    32-bit form."""
    if fix_tag is not None and n <= fix_max:
        out.append(_B.pack(fix_tag | n))
        return
    t8, t16, t32 = tags
    if t8 is not None and n <= 0xFF:
        out.append(bytes((t8,)) + _B.pack(n))
    elif n <= 0xFFFF:
        out.append(bytes((t16,)) + _H.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(bytes((t32,)) + _I.pack(n))
    else:
        raise ValueError(f"length {n} too large for msgpack")


def _pack(v, out: list) -> None:
    if v is None:
        out.append(b"\xc0")
    elif v is True:
        out.append(b"\xc3")
    elif v is False:
        out.append(b"\xc2")
    elif type(v) is int:
        _int(v, out)
    elif type(v) is float:
        out.append(b"\xcb" + _d.pack(v))
    elif type(v) is str:
        data = v.encode("utf-8")
        _len_header(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif type(v) in (bytes, bytearray, memoryview):
        data = bytes(v)
        _len_header(len(data), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(data)
    elif type(v) in (list, tuple):
        _len_header(len(v), 0x90, 15, (None, 0xDC, 0xDD), out)
        for item in v:
            _pack(item, out)
    elif type(v) is dict:
        _len_header(len(v), 0x80, 15, (None, 0xDE, 0xDF), out)
        for key, item in v.items():
            _pack(key, out)
            _pack(item, out)
    else:
        raise TypeError(f"can not serialize {type(v).__name__!r} object")


def packb(obj) -> bytes:
    """msgpack bytes of ``obj`` (the types of this module's docstring)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data truncated")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


def _read(r: _Reader):
    tag = r.unpack(_B)
    if tag <= 0x7F:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if 0xA0 <= tag <= 0xBF:
        return r.take(tag & 0x1F).decode("utf-8")
    if 0x90 <= tag <= 0x9F:
        return [_read(r) for _ in range(tag & 0x0F)]
    if 0x80 <= tag <= 0x8F:
        return _read_map(r, tag & 0x0F)
    if tag == 0xC0:
        return None
    if tag == 0xC2:
        return False
    if tag == 0xC3:
        return True
    fixed = {0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
             0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q, 0xCA: _f, 0xCB: _d}
    if tag in fixed:
        return r.unpack(fixed[tag])
    lengths = {0xD9: _B, 0xDA: _H, 0xDB: _I, 0xC4: _B, 0xC5: _H, 0xC6: _I,
               0xDC: _H, 0xDD: _I, 0xDE: _H, 0xDF: _I}
    if tag not in lengths:
        raise TypeError(f"msgpack type 0x{tag:02x} is outside this subset")
    n = r.unpack(lengths[tag])
    if tag in (0xD9, 0xDA, 0xDB):
        return r.take(n).decode("utf-8")
    if tag in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(n))
    if tag in (0xDC, 0xDD):
        return [_read(r) for _ in range(n)]
    return _read_map(r, n)


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        out[key] = _read(r)
    return out


def unpackb(data: bytes):
    """The object msgpack's ``unpackb`` gives for ``data`` (one object,
    nothing after it)."""
    r = _Reader(bytes(data))
    obj = _read(r)
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} extra bytes after the object")
    return obj
