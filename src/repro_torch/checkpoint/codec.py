"""The msgpack subset of the checkpoint file, written and read without the
``msgpack`` package.

Types: maps, arrays (lists and tuples), str (str8/16/32 — msgpack's
``use_bin_type=True`` form), bin8/16/32, ints in their smallest encoding
(positive and negative fixint, uint8-64, int8-64), bool and nil.  The
writer gives exactly the bytes of ``msgpack.packb(obj, use_bin_type=True)``.

A checkpoint holds the whole train state (gigabytes at full width), so
:func:`write_payload` streams it leaf by leaf into an open file, and
:func:`unpackb` returns every bin as a ``memoryview`` slice of its input —
over an ``mmap`` of the file, nothing is copied until a leaf is decoded.
"""
from __future__ import annotations

import struct


def _sized(n: int, small: int | None, codes: tuple) -> bytes:
    """The header of a sized type: ``small | n`` below its fix limit, else
    the 8/16/32-bit length forms in ``codes`` (None where absent)."""
    if small is not None and n < (32 if small == 0xa0 else 16):
        return bytes([small | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def map_header(n: int) -> bytes:
    return _sized(n, 0x80, (None, 0xde, 0xdf))


def array_header(n: int) -> bytes:
    return _sized(n, 0x90, (None, 0xdc, 0xdd))


def bin_header(n: int) -> bytes:
    return _sized(n, None, (0xc4, 0xc5, 0xc6))


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xa0, (0xd9, 0xda, 0xdb)) + b


def _int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                 (0xce, ">I", 1 << 32),
                                 (0xcf, ">Q", 1 << 64)):
            if v < limit:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, limit in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                                 (0xd2, ">i", 1 << 31),
                                 (0xd3, ">q", 1 << 63)):
            if v >= -limit:
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: int {v} out of range")


def _encode(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, str):
        out.append(_str(obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B")
        out.append(bin_header(len(data)))
        out.append(data)
    elif isinstance(obj, dict):
        out.append(map_header(len(obj)))
        for k, v in obj.items():
            _encode(k, out)
            _encode(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(array_header(len(obj)))
        for v in obj:
            _encode(v, out)
    else:
        raise TypeError(f"msgpack subset: cannot encode {type(obj).__name__}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset's types."""
    out = []
    _encode(obj, out)
    return b"".join(out)


def write_payload(f, treedef: str, n_leaves: int, leaves) -> int:
    """Stream ``{"treedef": treedef, "leaves": [{"dtype", "shape",
    "data"}, ...]}`` into the binary file ``f``, one leaf at a time.
    ``leaves`` yields ``n_leaves`` triples (dtype str, shape, C-order data
    as any buffer); only one leaf's data is held at a time.  Returns the
    bytes written."""
    head = map_header(2) + _str("treedef") + _str(treedef) + _str("leaves") \
        + array_header(n_leaves)
    n = f.write(head)
    count = 0
    for dtype, shape, data in leaves:
        data = memoryview(data).cast("B")
        n += f.write(map_header(3) + _str("dtype") + _str(dtype)
                     + _str("shape") + packb(list(shape)) + _str("data")
                     + bin_header(len(data)))
        n += f.write(data)
        count += 1
    if count != n_leaves:
        raise ValueError(f"write_payload: {count} leaves, announced "
                         f"{n_leaves}")
    return n


_FIX_LEN = {0xc4: 1, 0xc5: 2, 0xc6: 4, 0xd9: 1, 0xda: 2, 0xdb: 4,
            0xdc: 2, 0xdd: 4, 0xde: 2, 0xdf: 4}
_INTS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
         0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}


def unpackb(buf):
    """Decode one object of the subset from ``buf`` (bytes, or a
    memoryview of an mmap).  str comes back as str, bin as a memoryview
    slice of ``buf``.  Raises on trailing bytes or a type outside the
    subset."""
    mv = memoryview(buf).cast("B")
    obj, pos = _decode(mv, 0)
    if pos != len(mv):
        raise ValueError(f"msgpack: {len(mv) - pos} trailing bytes")
    return obj


def _length(mv, pos, code):
    size = _FIX_LEN[code]
    fmt = {1: ">B", 2: ">H", 4: ">I"}[size]
    return struct.unpack_from(fmt, mv, pos)[0], pos + size


def _decode(mv, pos):
    code = mv[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xe0:
        return code - 0x100, pos
    if 0x80 <= code < 0x90 or code in (0xde, 0xdf):
        n, pos = ((code & 0x0f, pos) if code < 0x90
                  else _length(mv, pos, code))
        out = {}
        for _ in range(n):
            k, pos = _decode(mv, pos)
            out[k], pos = _decode(mv, pos)
        return out, pos
    if 0x90 <= code < 0xa0 or code in (0xdc, 0xdd):
        n, pos = ((code & 0x0f, pos) if code < 0xa0
                  else _length(mv, pos, code))
        out = []
        for _ in range(n):
            v, pos = _decode(mv, pos)
            out.append(v)
        return out, pos
    if 0xa0 <= code < 0xc0 or code in (0xd9, 0xda, 0xdb):
        n, pos = ((code & 0x1f, pos) if code < 0xc0
                  else _length(mv, pos, code))
        return bytes(mv[pos:pos + n]).decode("utf-8"), pos + n
    if code in (0xc4, 0xc5, 0xc6):
        n, pos = _length(mv, pos, code)
        return mv[pos:pos + n], pos + n
    if code in _INTS:
        fmt = _INTS[code]
        return struct.unpack_from(fmt, mv, pos)[0], pos + struct.calcsize(fmt)
    if code in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[code], pos
    raise ValueError(f"msgpack subset: type byte {code:#04x} not supported")
