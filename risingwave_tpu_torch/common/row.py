"""Row representation and memcomparable key encoding (host tier).

Counterpart of ``risingwave_tpu/common/row.py``, byte for byte over every
kind (INT16 keys as 16 bits, INT32 and DATE as 32, every other integral
kind, DECIMAL's scaled int64 included, as 64; FLOAT32 and FLOAT64 as
float64): encoded keys compare bytewise in the order of the logical
values, which gives the state store sorted iteration and prefix scans.
Only physical scalars appear here. VARCHAR, BYTEA and JSONB arrive as
dictionary ids and are written as their string bytes, so order is
lexicographic and a recovering process re-interns the string. LIST and
STRUCT ids are written by content: a list element by element (each
behind a ``\x01``, a ``\x00`` at the end of a key; a count before a
value), a struct field by field in declared order (its arity checked),
each element or field through its own type; decoding interns into this
package's dictionaries.
"""

from __future__ import annotations

import struct
from typing import Any, Optional, Sequence

from .types import GLOBAL_LIST_DICT, GLOBAL_STRING_DICT, DataType, TypeKind

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
    if k == TypeKind.LIST:
        # a proper-prefix list sorts before its extensions
        et = t.elem_type
        parts = []
        for e in GLOBAL_LIST_DICT.lookup(int(v)):
            parts.append(b"\x01")
            parts.append(encode_value(
                None if e is None else et.to_physical(e), et))
        return _VAL_TAG + b"".join(parts) + b"\x00"
    if k == TypeKind.STRUCT:
        fields, ftypes = _struct_fields(v, t)
        return _VAL_TAG + b"".join(
            encode_value(None if e is None else ft.to_physical(e), ft)
            for e, ft in zip(fields, ftypes))
    if t.is_float:
        return _VAL_TAG + _enc_float(float(v))
    if k == TypeKind.INT16:
        return _VAL_TAG + _enc_int(int(v), 16)
    if k in (TypeKind.INT32, TypeKind.DATE):
        return _VAL_TAG + _enc_int(int(v), 32)
    return _VAL_TAG + _enc_int(int(v), 64)


def _struct_fields(v: Any, t: DataType) -> tuple[tuple, list]:
    """A struct id's field values and the declared field types, their
    counts checked against each other."""
    fields = GLOBAL_LIST_DICT.lookup(int(v))
    ftypes = [ft for _, ft in (t.struct_fields or ())]
    if len(fields) != len(ftypes):
        raise ValueError(f"struct value arity {len(fields)} != declared "
                         f"{len(ftypes)}")
    return fields, ftypes


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
        elif t.kind == TypeKind.LIST:
            # the dictionary holds python elements: each goes through the
            # element type's physical form
            elems = GLOBAL_LIST_DICT.lookup(int(v))
            et = t.elem_type
            parts.append(struct.pack("<I", len(elems)))
            parts.append(encode_value_row(
                [None if e is None else et.to_physical(e) for e in elems],
                [et] * len(elems)))
        elif t.kind == TypeKind.STRUCT:
            # a fixed arity from the declared field types: no count
            fields, ftypes = _struct_fields(v, t)
            parts.append(encode_value_row(
                [None if e is None else ft.to_physical(e)
                 for e, ft in zip(fields, ftypes)], ftypes))
        elif t.is_float:
            parts.append(struct.pack("<d", float(v)))
        else:
            parts.append(struct.pack("<q", int(v)))
    return b"".join(parts)


def _decode_values(data: bytes, pos: int,
                   types: Sequence[DataType]) -> tuple[list, int]:
    out: list = []
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
        elif t.kind == TypeKind.LIST:
            (n,) = struct.unpack_from("<I", data, pos)
            et = t.elem_type
            phys, pos = _decode_values(data, pos + 4, [et] * n)
            out.append(GLOBAL_LIST_DICT.intern(
                [None if e is None else et.to_python(e) for e in phys]))
        elif t.kind == TypeKind.STRUCT:
            ftypes = [ft for _, ft in (t.struct_fields or ())]
            phys, pos = _decode_values(data, pos, ftypes)
            out.append(GLOBAL_LIST_DICT.intern(
                [None if e is None else ft.to_python(e)
                 for e, ft in zip(phys, ftypes)]))
        elif t.is_float:
            (f,) = struct.unpack_from("<d", data, pos)
            pos += 8
            out.append(f)
        else:
            (i,) = struct.unpack_from("<q", data, pos)
            pos += 8
            out.append(i)
    return out, pos


def decode_value_row(data: bytes, types: Sequence[DataType]) -> tuple:
    """Durable bytes -> physical row tuple (strings, lists and structs
    re-interned)."""
    return tuple(_decode_values(data, 0, types)[0])


def encode_vnode_key(vnode: int, values: Sequence,
                     types: Sequence[DataType]) -> bytes:
    """vnode-prefixed key: ``vnode | key`` (the table id is the store's
    namespace)."""
    return vnode.to_bytes(2, "big") + encode_key(values, types)
