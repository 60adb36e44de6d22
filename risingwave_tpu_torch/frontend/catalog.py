"""Copy of ``risingwave_tpu/frontend/catalog.py``: the reference's text, its
relative imports resolving to the port's modules. One change:
``type_from_name`` gives ``decimal(p,s)`` scale s and ``decimal(p)`` scale
0 (the reference gives every DECIMAL scale 2, ROADMAP C3).

Catalog: sources, tables, materialized views, indexes.

Counterpart of the reference's CatalogManager + frontend catalog cache
(reference: src/meta/src/manager/catalog/, src/frontend/src/catalog/ —
single-process here, one authoritative copy; the meta/frontend split returns
when the cluster runtime lands).
"""

from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Optional

from ..common.types import (
    BOOL, DATE, FLOAT32, FLOAT64, INT16, INT32, INT64, INTERVAL, JSONB,
    TIME, TIMESTAMP, VARCHAR, DataType, Field, Schema, decimal,
)

_TYPE_NAMES: dict[str, DataType] = {
    "boolean": BOOL, "bool": BOOL,
    "smallint": INT16, "int2": INT16,
    "int": INT32, "integer": INT32, "int4": INT32,
    "bigint": INT64, "int8": INT64,
    "real": FLOAT32, "float4": FLOAT32,
    "double": FLOAT64, "float8": FLOAT64, "float": FLOAT64,
    "decimal": decimal(), "numeric": decimal(),
    "date": DATE, "time": TIME,
    "timestamp": TIMESTAMP, "timestamptz": TIMESTAMP,
    "interval": INTERVAL,
    "varchar": VARCHAR, "text": VARCHAR, "string": VARCHAR,
    "serial": INT64,
    "jsonb": JSONB, "json": JSONB,
}


def _split_struct_body(body: str) -> list:
    """Split 'a bigint, b struct<x int, y int>' on TOP-LEVEL commas."""
    parts, depth, cur = [], 0, []
    for ch in body:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts


def type_from_name(name: str) -> DataType:
    low = name.lower().strip()
    if low.startswith("struct<") and low.endswith(">"):
        from ..common.types import struct_of
        fields = []
        for part in _split_struct_body(low[len("struct<"):-1]):
            fname, _, ftype = part.strip().partition(" ")
            fields.append((fname, type_from_name(ftype.strip())))
        return struct_of(*fields)
    size = re.fullmatch(r"(decimal|numeric)\((\d+)(?:,\s*(\d+))?\)", low)
    if size is not None:
        # DECIMAL(p, s) has scale s, DECIMAL(p) scale 0 (PostgreSQL)
        return decimal(int(size.group(3) or 0))
    t = _TYPE_NAMES.get(low)
    if t is None:
        raise ValueError(f"unknown type name {name!r}")
    return t


@dataclasses.dataclass
class SourceDef:
    name: str
    schema: Schema
    connector: str
    options: dict
    watermark: Optional[tuple] = None      # (col_name, delay_us)
    append_only: bool = True


@dataclasses.dataclass
class TableDef:
    name: str
    schema: Schema
    pk: tuple                               # column indices
    table_id: int = -1
    append_only: bool = False


@dataclasses.dataclass
class MaterializedViewDef:
    name: str
    schema: Schema
    pk: tuple                               # column indices into schema
    table_id: int = -1
    definition: str = ""


@dataclasses.dataclass
class SinkDef:
    """Reference: sink catalog entry (src/connector/src/sink/catalog/).
    ``table_id`` is the log-store table; ``progress_table_id`` holds the
    delivered-epoch/position row (stream/sink.py)."""

    name: str
    schema: Schema
    connector: str
    options: dict
    from_name: str = ""
    table_id: int = -1
    progress_table_id: int = -1


@dataclasses.dataclass
class IndexDef:
    name: str
    table: str
    columns: tuple
    #: hidden MV materializing (index cols ⧺ remaining visible cols) with
    #: state-table pk = index cols ⧺ base pk — the arrangement batch
    #: lookups prefix-scan (reference: index = StreamMaterialize ordered
    #: by index columns, src/frontend/src/handler/create_index.rs)
    mv_name: str = ""


class CatalogError(ValueError):
    pass


def strip_schema(name: str) -> str:
    """Normalize a possibly schema-qualified relation name: the catalog
    is keyed on bare names and everything lives in 'public' (BI tools
    qualify with the schema pg_tables reports)."""
    return name[len("public."):] if name.startswith("public.") else name


class Catalog:
    def __init__(self) -> None:
        self.sources: dict[str, SourceDef] = {}
        self.tables: dict[str, TableDef] = {}
        self.mvs: dict[str, MaterializedViewDef] = {}
        self.sinks: dict[str, SinkDef] = {}
        self.indexes: dict[str, IndexDef] = {}
        # plain int (not itertools.count) so DDL can roll it back on failure:
        # a failed statement must not shift later statements' table ids or
        # recovery replay (which skips failed DDL) would allocate different
        # ids than the original run
        self._next_table_id = 1

    def next_table_id(self) -> int:
        i = self._next_table_id
        self._next_table_id += 1
        return i

    def _check_free(self, name: str) -> None:
        for reg in (self.sources, self.tables, self.mvs, self.sinks,
                    self.indexes):
            if name in reg:
                raise CatalogError(f"name {name!r} already in use")

    def add_source(self, s: SourceDef) -> None:
        self._check_free(s.name)
        self.sources[s.name] = s

    def add_table(self, t: TableDef) -> None:
        self._check_free(t.name)
        if t.table_id < 0:
            t.table_id = self.next_table_id()
        self.tables[t.name] = t

    def add_mv(self, mv: MaterializedViewDef) -> None:
        self._check_free(mv.name)
        if mv.table_id < 0:
            mv.table_id = self.next_table_id()
        self.mvs[mv.name] = mv

    def add_sink(self, s: SinkDef) -> None:
        self._check_free(s.name)
        self.sinks[s.name] = s

    def add_index(self, ix: IndexDef) -> None:
        self._check_free(ix.name)
        self.indexes[ix.name] = ix

    def resolve_relation(self, name: str):
        """-> ("source"|"table"|"mv", def)"""
        name = strip_schema(name)
        if name in self.sources:
            return "source", self.sources[name]
        if name in self.tables:
            return "table", self.tables[name]
        if name in self.mvs:
            return "mv", self.mvs[name]
        raise CatalogError(f"relation {name!r} not found")

    def drop(self, kind: str, name: str, if_exists: bool = False) -> bool:
        name = strip_schema(name)
        reg = {
            "source": self.sources, "table": self.tables,
            "materialized_view": self.mvs, "sink": self.sinks,
            "index": self.indexes,
        }[kind]
        if name not in reg:
            if if_exists:
                return False
            raise CatalogError(f"{kind} {name!r} not found")
        del reg[name]
        return True
