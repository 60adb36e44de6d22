"""Row representation and memcomparable key encoding (host tier).

Counterpart of ``risingwave_tpu/common/row.py``, byte for byte over this
package's scalar kinds (INT16 keys as 16 bits, INT32 and DATE as 32,
every other integral kind, DECIMAL's scaled int64 included, as 64; FLOAT32
and FLOAT64 as float64): encoded keys compare bytewise in the order of the
logical values, which gives the state store sorted iteration and prefix
scans. Only physical scalars appear here. VARCHAR arrives as a dictionary
id and is written as its string bytes, so order is lexicographic and a
recovering process re-interns the string.
"""

from __future__ import annotations

import struct
from typing import Any, Optional, Sequence

from .types import GLOBAL_STRING_DICT, DataType, TypeKind

_NULL_TAG = b"\x00"   # nulls sort first
_VAL_TAG = b"\x01"


def _enc_int(v: int, bits: int) -> bytes:
    # flip the sign bit: unsigned bytewise order matches signed order
    off = 1 << (bits - 1)
    return int(v + off).to_bytes(bits // 8, "big")


def _dec_int(b: bytes, bits: int) -> int:
    off = 1 << (bits - 1)
    return int.from_bytes(b, "big") - off


def _enc_float(v: float) -> bytes:
    bits = struct.unpack(">Q", struct.pack(">d", float(v)))[0]
    if bits & (1 << 63):
        bits = ~bits & 0xFFFFFFFFFFFFFFFF   # negative: flip all
    else:
        bits |= 1 << 63                      # positive: flip sign
    return bits.to_bytes(8, "big")


def _dec_float(b: bytes) -> float:
    bits = int.from_bytes(b, "big")
    if bits & (1 << 63):
        bits &= ~(1 << 63) & 0xFFFFFFFFFFFFFFFF
    else:
        bits = ~bits & 0xFFFFFFFFFFFFFFFF
    return struct.unpack(">d", struct.pack(">Q", bits))[0]


def _enc_str(s: str) -> bytes:
    # escape embedded zero bytes, end with 0x00 0x00 so prefixes sort first
    raw = s.encode("utf-8").replace(b"\x00", b"\x00\xff")
    return raw + b"\x00\x00"


def encode_value(v: Optional[Any], t: DataType) -> bytes:
    """Physical scalar -> memcomparable bytes (nulls first)."""
    if v is None:
        return _NULL_TAG
    k = t.kind
    if k == TypeKind.BOOL:
        return _VAL_TAG + (b"\x01" if v else b"\x00")
    if t.is_string:
        return _VAL_TAG + _enc_str(GLOBAL_STRING_DICT.lookup(int(v)))
    if t.is_float:
        return _VAL_TAG + _enc_float(float(v))
    if k == TypeKind.INT16:
        return _VAL_TAG + _enc_int(int(v), 16)
    if k in (TypeKind.INT32, TypeKind.DATE):
        return _VAL_TAG + _enc_int(int(v), 32)
    return _VAL_TAG + _enc_int(int(v), 64)


def encode_key(values: Sequence[Optional[Any]],
               types: Sequence[DataType]) -> bytes:
    """Physical row (via ``DataType.to_physical``) -> sortable key bytes."""
    return b"".join(encode_value(v, t) for v, t in zip(values, types))


# ---------------------------------------------------------------------------
# Value encoding — the durable row form. Not order-preserving; compact,
# self-delimiting per the schema and process-independent: VARCHAR is stored
# as its string bytes, not as a process-local dictionary id.
# ---------------------------------------------------------------------------

_NULL = b"\x00"
_PRESENT = b"\x01"


def encode_value_row(row: Sequence[Optional[Any]],
                     types: Sequence[DataType]) -> bytes:
    """Physical row tuple -> durable bytes."""
    parts = []
    for v, t in zip(row, types):
        if v is None:
            parts.append(_NULL)
            continue
        parts.append(_PRESENT)
        if t.kind == TypeKind.BOOL:
            parts.append(b"\x01" if v else b"\x00")
        elif t.is_string:
            raw = GLOBAL_STRING_DICT.lookup(int(v)).encode("utf-8")
            parts.append(struct.pack("<I", len(raw)))
            parts.append(raw)
        elif t.is_float:
            parts.append(struct.pack("<d", float(v)))
        else:
            parts.append(struct.pack("<q", int(v)))
    return b"".join(parts)


def decode_value_row(data: bytes, types: Sequence[DataType]) -> tuple:
    """Durable bytes -> physical row tuple (strings re-interned)."""
    out: list = []
    pos = 0
    for t in types:
        tag = data[pos]
        pos += 1
        if tag == 0:
            out.append(None)
        elif t.kind == TypeKind.BOOL:
            out.append(bool(data[pos]))
            pos += 1
        elif t.is_string:
            (n,) = struct.unpack_from("<I", data, pos)
            pos += 4
            out.append(GLOBAL_STRING_DICT.intern(
                data[pos:pos + n].decode("utf-8")))
            pos += n
        elif t.is_float:
            (f,) = struct.unpack_from("<d", data, pos)
            pos += 8
            out.append(f)
        else:
            (i,) = struct.unpack_from("<q", data, pos)
            pos += 8
            out.append(i)
    return tuple(out)


def encode_vnode_key(vnode: int, values: Sequence,
                     types: Sequence[DataType]) -> bytes:
    """vnode-prefixed key: ``vnode | key`` (the table id is the store's
    namespace)."""
    return vnode.to_bytes(2, "big") + encode_key(values, types)
