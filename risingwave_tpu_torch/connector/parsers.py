"""Format parsers: encoded source lines → typed rows (host code).

Counterpart of ``risingwave_tpu/connector/parsers.py``: JSON lines, CSV and
Debezium change events into python rows in schema order, which
``common/chunk.py::make_chunk`` interns and puts on the device. It is the
ingest path of STRUCT, LIST and JSONB values. Two departures from the
reference, whose results differ from the same values built directly
(ROADMAP C3): each STRUCT field is coerced by its own declared type (the
reference coerces every field to text), and JSONB given as JSON text is
canonicalised as a JSON object is, so equal JSON values get one dictionary
id. A DECIMAL comes out as a float (the reference keeps the text), so a
struct holding one interns as the struct built from the number.
"""

from __future__ import annotations

import csv as _csv
import io
import json
from typing import Any, List, Optional, Sequence

from ..common.chunk import (
    OP_DELETE, OP_INSERT, OP_UPDATE_DELETE, OP_UPDATE_INSERT,
)
from ..common.types import DataType, Schema, TypeKind, canonical_json

_INT_KINDS = (TypeKind.INT16, TypeKind.INT32, TypeKind.INT64,
              TypeKind.SERIAL, TypeKind.DATE, TypeKind.TIME,
              TypeKind.TIMESTAMP, TypeKind.INTERVAL)


def _coerce(v: Any, t: DataType) -> Any:
    if v is None:
        return None
    kind = t.kind
    if kind == TypeKind.STRUCT:
        # a nested JSON object -> its field tuple in declared order
        if isinstance(v, dict):
            return tuple(_coerce(v.get(fn), ft)
                         for fn, ft in t.struct_fields)
        return None
    if kind == TypeKind.LIST:
        if isinstance(v, (list, tuple)):
            return tuple(_coerce(e, t.elem_type) for e in v)
        return None
    if kind == TypeKind.JSONB:
        return canonical_json(json.loads(v) if isinstance(v, str) else v)
    if kind in _INT_KINDS:
        return int(v)
    if kind in (TypeKind.FLOAT32, TypeKind.FLOAT64, TypeKind.DECIMAL):
        return float(v)
    if kind == TypeKind.BOOL:
        if isinstance(v, str):
            return v.strip().lower() in ("t", "true", "1", "yes")
        return bool(v)
    return str(v)


def parse_json_line(line: str, schema: Schema) -> Optional[tuple]:
    """One JSON object → a row in schema order; unknown keys are ignored,
    missing keys NULL. None for a blank line."""
    line = line.strip()
    if not line:
        return None
    obj = json.loads(line)
    return tuple(_coerce(obj.get(f.name), f.type) for f in schema)


def parse_json_lines(text: str, schema: Schema) -> List[tuple]:
    rows = []
    for line in text.splitlines():
        r = parse_json_line(line, schema)
        if r is not None:
            rows.append(r)
    return rows


def parse_csv_lines(text: str, schema: Schema, has_header: bool = True,
                    delimiter: str = ",") -> List[tuple]:
    """CSV text → rows. With a header, columns are matched by name;
    without, by position."""
    reader = _csv.reader(io.StringIO(text), delimiter=delimiter)
    rows: List[tuple] = []
    col_order: Optional[Sequence[int]] = None
    first = True
    for rec in reader:
        if not rec:
            continue
        if first and has_header:
            name_to_pos = {n.strip(): i for i, n in enumerate(rec)}
            col_order = [name_to_pos.get(f.name, -1) for f in schema]
            first = False
            continue
        first = False
        if col_order is None:
            col_order = list(range(len(schema)))
        vals = []
        for f, pos in zip(schema, col_order):
            raw = rec[pos] if 0 <= pos < len(rec) else None
            vals.append(None if raw in (None, "") else _coerce(raw, f.type))
        rows.append(tuple(vals))
    return rows


def parse_debezium_line(line: str, schema: Schema) -> List[tuple]:
    """One Debezium-JSON change event ({before, after, op}, flat or inside
    a Kafka Connect ``payload``) → [(op, row), ...]: c/r → Insert(after);
    u → UpdateDelete(before) + UpdateInsert(after), or an Insert(after)
    when there is no before image; d → Delete(before)."""
    line = line.strip()
    if not line:
        return []
    obj = json.loads(line)
    if not isinstance(obj, dict):
        raise ValueError(f"debezium event is not an object: {line[:40]!r}")
    payload = obj.get("payload", obj)
    if not isinstance(payload, dict):
        raise ValueError("debezium payload is not an object")

    def row_of(img):
        if not isinstance(img, dict):
            raise ValueError("debezium row image is not an object")
        return tuple(_coerce(img.get(f.name), f.type) for f in schema)

    op = payload.get("op")
    before, after = payload.get("before"), payload.get("after")
    if op in ("c", "r") and after is not None:
        return [(OP_INSERT, row_of(after))]
    if op == "u" and after is not None:
        if before is None:
            return [(OP_INSERT, row_of(after))]
        return [(OP_UPDATE_DELETE, row_of(before)),
                (OP_UPDATE_INSERT, row_of(after))]
    if op == "d" and before is not None:
        return [(OP_DELETE, row_of(before))]
    raise ValueError(
        f"malformed debezium event: op={op!r}, "
        f"before={'set' if before is not None else None}, "
        f"after={'set' if after is not None else None}")


def parse_debezium_lines(text: str, schema: Schema) -> List[tuple]:
    """Debezium-JSON lines → [(op, row), ...]."""
    out: List[tuple] = []
    for line in text.splitlines():
        out.extend(parse_debezium_line(line, schema))
    return out
