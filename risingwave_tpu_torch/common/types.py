"""Logical type system for the data plane.

Counterpart of ``risingwave_tpu/common/types.py``: every logical type lowers
to a fixed-width tensor dtype (DECIMAL a scaled int64, DATE int32 days).
The varlen types are dictionary-encoded at the ingest boundary, so the
device sees int32 ids: VARCHAR, BYTEA and JSONB (canonical JSON text)
into the host's process-wide ``GLOBAL_STRING_DICT``, LIST and STRUCT
values (python tuples: a list's elements, a struct's fields in declared
order) into ``GLOBAL_LIST_DICT``. ``to_physical`` interns and
``to_python`` looks up. Ids are insertion-ordered, so every ordering on
VARCHAR goes through the dictionary's rank table (``StringDict.ranks`` /
``device_ranks``).
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import json
import threading
from typing import Any, Optional

import numpy as np
import torch


class TypeKind(enum.Enum):
    BOOL = "boolean"
    INT16 = "smallint"
    INT32 = "int"
    INT64 = "bigint"
    FLOAT32 = "real"
    FLOAT64 = "double"
    DECIMAL = "decimal"        # scaled int64 (fixed point)
    DATE = "date"              # int32 days since epoch
    TIME = "time"              # int64 microseconds since midnight
    TIMESTAMP = "timestamp"    # int64 microseconds since epoch
    INTERVAL = "interval"      # int64 microseconds (no month component)
    VARCHAR = "varchar"        # int32 dictionary id
    BYTEA = "bytea"            # int32 dictionary id
    SERIAL = "serial"          # int64 row id (shard-prefixed)
    LIST = "list"              # int32 list-dictionary id (value-interned)
    JSONB = "jsonb"            # int32 dictionary id (canonical JSON text)
    STRUCT = "struct"          # int32 list-dictionary id (field tuple)


_PHYSICAL: dict[TypeKind, torch.dtype] = {
    TypeKind.BOOL: torch.bool,
    TypeKind.INT16: torch.int16,
    TypeKind.INT32: torch.int32,
    TypeKind.INT64: torch.int64,
    TypeKind.FLOAT32: torch.float32,
    TypeKind.FLOAT64: torch.float64,
    TypeKind.DECIMAL: torch.int64,
    TypeKind.DATE: torch.int32,
    TypeKind.TIME: torch.int64,
    TypeKind.TIMESTAMP: torch.int64,
    TypeKind.INTERVAL: torch.int64,
    TypeKind.VARCHAR: torch.int32,
    TypeKind.BYTEA: torch.int32,
    TypeKind.SERIAL: torch.int64,
    TypeKind.LIST: torch.int32,
    TypeKind.JSONB: torch.int32,
    TypeKind.STRUCT: torch.int32,
}

_NP_OF_TORCH = {torch.bool: np.bool_, torch.int16: np.int16,
                torch.int32: np.int32, torch.int64: np.int64,
                torch.float32: np.float32, torch.float64: np.float64}

_INTEGRAL = {TypeKind.INT16, TypeKind.INT32, TypeKind.INT64,
             TypeKind.SERIAL, TypeKind.DATE, TypeKind.TIME,
             TypeKind.TIMESTAMP, TypeKind.INTERVAL, TypeKind.DECIMAL}


class StringDict:
    """Host-side dictionary for VARCHAR columns.

    Interning happens on the ingest path and decoding on the egress path;
    device code only compares, hashes or moves the int32 ids. Id 0 is the
    empty string, so zero-initialised buffers decode cleanly. Growth is
    bounded by ``max_size``: hitting it is a capacity-planning error raised
    loudly. Ids are insertion-ordered, so no ordering operation may use
    them raw; they never cross a process boundary (the durable row format
    in ``row.py`` stores the string bytes)."""

    __slots__ = ("_to_id", "_to_str", "max_size", "_lock", "_sorted",
                 "_unsorted", "_rank_version", "_ranks", "_device_ranks")

    DEFAULT_MAX = 1 << 22          # 4M distinct strings

    def __init__(self, max_size: int = DEFAULT_MAX) -> None:
        self._lock = threading.Lock()
        self._to_id: dict[str, int] = {"": 0}
        self._to_str: list[str] = [""]
        self.max_size = max_size
        # sorted prefix + unsorted suffix: interning stays an append, and a
        # rank refresh merges the suffix in (no full re-sort)
        self._sorted: list[str] = [""]
        self._unsorted: list[str] = []
        self._rank_version = -1
        self._ranks: Optional[np.ndarray] = None
        # device -> (version, padded int64 rank table on that device)
        self._device_ranks: dict = {}

    def intern(self, s: str) -> int:
        i = self._to_id.get(s)
        if i is not None:
            return i
        # check-then-append must be atomic when two threads intern
        with self._lock:
            i = self._to_id.get(s)
            if i is None:
                if len(self._to_str) >= self.max_size:
                    raise RuntimeError(
                        f"string dictionary full ({self.max_size} distinct "
                        "values); raise StringDict.max_size or reduce "
                        "string cardinality")
                i = len(self._to_str)
                self._to_id[s] = i
                self._to_str.append(s)
                self._unsorted.append(s)
        return i

    def lookup(self, i: int) -> str:
        return self._to_str[i]

    def __len__(self) -> int:
        return len(self._to_str)

    # -- ordering --------------------------------------------------------------
    # State always stores ids (stable as the dictionary grows); ranks are
    # looked up fresh wherever an ordering is computed.

    @property
    def version(self) -> int:
        """Grows by one exactly when a new string is interned."""
        return len(self._to_str)

    def ranks(self) -> np.ndarray:
        """int64[version]: ``ranks()[id]`` is the rank of string ``id`` in
        codepoint order. A refresh merges the strings interned since the
        last one into the sorted prefix; cached per version."""
        n = len(self._to_str)
        if self._rank_version != n:
            if self._unsorted:
                self._sorted = list(heapq.merge(self._sorted,
                                                sorted(self._unsorted)))
                self._unsorted = []
            pos = {s: i for i, s in enumerate(self._sorted)}
            self._ranks = np.fromiter((pos[s] for s in self._to_str[:n]),
                                      np.int64, n)
            self._rank_version = n
        return self._ranks

    def device_ranks(self, device) -> torch.Tensor:
        """The rank table on ``device``, padded to a power of two (at least
        8); padding ranks as ``version``, above every live string. Cached
        per device and version; "cuda" and the current "cuda:N" share one
        entry, so the executors (given "cuda") and the expressions (given a
        tensor's "cuda:0") never build two."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        n = len(self._to_str)
        hit = self._device_ranks.get(dev)
        if hit is None or hit[0] != n:
            cap = 8
            while cap < n:
                cap *= 2
            t = np.full(cap, n, np.int64)
            t[:n] = self.ranks()
            hit = (n, torch.from_numpy(t).to(dev))
            self._device_ranks[dev] = hit
        return hit[1]


def rank_of(ranks: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 lexicographic rank of each VARCHAR id through a rank table
    (``StringDict.device_ranks``); ids past the table clamp into it."""
    return ranks[ids.long().clamp(0, ranks.shape[0] - 1)]


#: the process-wide string dictionary: sources intern, sinks look up
GLOBAL_STRING_DICT = StringDict()


class ListDict:
    """Host-side dictionary of list values (python tuples, None = NULL
    element), interned by value so id equality is list equality. Id 0 is
    the empty list."""

    __slots__ = ("_to_id", "_to_list", "max_size", "_lock")

    DEFAULT_MAX = 1 << 22

    def __init__(self, max_size: int = DEFAULT_MAX):
        self._lock = threading.Lock()
        self._to_id: dict = {(): 0}
        self._to_list: list = [()]
        self.max_size = max_size

    def intern(self, value) -> int:
        t = tuple(value)
        i = self._to_id.get(t)
        if i is not None:
            return i
        with self._lock:        # see StringDict.intern
            i = self._to_id.get(t)
            if i is None:
                if len(self._to_list) >= self.max_size:
                    raise RuntimeError(
                        f"list dictionary full ({self.max_size} entries)")
                i = len(self._to_list)
                self._to_id[t] = i
                self._to_list.append(t)
        return i

    def lookup(self, i: int) -> tuple:
        return self._to_list[i]

    def __len__(self) -> int:
        return len(self._to_list)


GLOBAL_LIST_DICT = ListDict()


@dataclasses.dataclass(frozen=True)
class DataType:
    """A logical column type. ``scale`` is meaningful for DECIMAL only: the
    value is the int64 ``round(v * 10**scale)``. ``elem_kind`` only for
    LIST (the element type's kind); ``struct_fields`` only for STRUCT:
    ((name, DataType), ...), full field types, so a DECIMAL field keeps
    its scale and nested composites survive persistence and field
    access."""

    kind: TypeKind
    scale: int = 0
    elem_kind: Optional[TypeKind] = None
    struct_fields: Optional[tuple] = None

    @property
    def dtype(self) -> torch.dtype:
        return _PHYSICAL[self.kind]

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(_NP_OF_TORCH[self.dtype])

    @property
    def is_integral(self) -> bool:
        return self.kind in _INTEGRAL

    @property
    def is_float(self) -> bool:
        return self.kind in (TypeKind.FLOAT32, TypeKind.FLOAT64)

    @property
    def is_string(self) -> bool:
        """Dictionary-encoded text: VARCHAR, BYTEA and JSONB (canonical
        JSON text) ride every string path (interning, persistence by
        content, the host functions)."""
        return self.kind in (TypeKind.VARCHAR, TypeKind.BYTEA,
                             TypeKind.JSONB)

    @property
    def is_list(self) -> bool:
        return self.kind == TypeKind.LIST

    @property
    def is_struct(self) -> bool:
        return self.kind == TypeKind.STRUCT

    @property
    def elem_type(self) -> "DataType":
        assert self.kind == TypeKind.LIST and self.elem_kind is not None
        return DataType(self.elem_kind)

    def field_type(self, name: str) -> "DataType":
        return self.struct_fields[self.field_index(name)][1]

    def field_index(self, name: str) -> int:
        assert self.kind == TypeKind.STRUCT and self.struct_fields
        for i, (fname, _) in enumerate(self.struct_fields):
            if fname == name:
                return i
        raise KeyError(f"struct has no field {name!r}")

    def to_physical(self, v: Any) -> Any:
        """Python value → physical scalar for device buffers."""
        if v is None:
            return self.null_sentinel()
        if self.kind == TypeKind.DECIMAL:
            # as the reference writes it: through a float64 product
            return int(round(float(v) * 10**self.scale))
        if self.is_struct:
            n = len(tuple(v))
            if n != len(self.struct_fields or ()):
                raise ValueError(
                    f"struct value has {n} fields; type declares "
                    f"{len(self.struct_fields or ())}")
            return GLOBAL_LIST_DICT.intern(v)
        if self.is_list:
            return GLOBAL_LIST_DICT.intern(v)
        if self.is_string:
            return GLOBAL_STRING_DICT.intern(
                v if isinstance(v, str) else v.decode())
        if self.kind == TypeKind.BOOL:
            return bool(v)
        if self.is_float:
            return float(v)
        return int(v)

    def to_python(self, v: Any) -> Any:
        """Physical scalar → Python value (result rows / tests)."""
        if self.kind == TypeKind.DECIMAL:
            return int(v) / 10**self.scale if self.scale else int(v)
        if self.is_list or self.is_struct:
            return GLOBAL_LIST_DICT.lookup(int(v))
        if self.is_string:
            return GLOBAL_STRING_DICT.lookup(int(v))
        if self.kind == TypeKind.BOOL:
            return bool(v)
        if self.is_float:
            return float(v)
        return int(v)

    def null_sentinel(self) -> Any:
        """Filler for null/invisible slots; the validity mask is
        authoritative."""
        if self.kind == TypeKind.BOOL:
            return False
        if self.is_float:
            return 0.0
        return 0


BOOL = DataType(TypeKind.BOOL)
INT16 = DataType(TypeKind.INT16)
INT32 = DataType(TypeKind.INT32)
INT64 = DataType(TypeKind.INT64)
FLOAT32 = DataType(TypeKind.FLOAT32)
FLOAT64 = DataType(TypeKind.FLOAT64)
DATE = DataType(TypeKind.DATE)
TIME = DataType(TypeKind.TIME)
TIMESTAMP = DataType(TypeKind.TIMESTAMP)
INTERVAL = DataType(TypeKind.INTERVAL)
VARCHAR = DataType(TypeKind.VARCHAR)
BYTEA = DataType(TypeKind.BYTEA)
SERIAL = DataType(TypeKind.SERIAL)
JSONB = DataType(TypeKind.JSONB)


def decimal(scale: int = 2) -> DataType:
    return DataType(TypeKind.DECIMAL, scale=scale)


def canonical_json(v: Any) -> str:
    """A JSON value's JSONB text: sorted keys, no spaces, so equal JSON
    values intern to one id."""
    return json.dumps(v, separators=(",", ":"), sort_keys=True)


def list_of(elem: DataType) -> DataType:
    return DataType(TypeKind.LIST, elem_kind=elem.kind)


def struct_of(*fields) -> DataType:
    """``struct_of(("a", INT64), ("b", VARCHAR))``: full field DataTypes
    (a bare TypeKind is wrapped)."""
    return DataType(TypeKind.STRUCT, struct_fields=tuple(
        (n, t if isinstance(t, DataType) else DataType(t))
        for n, t in fields))


@dataclasses.dataclass(frozen=True)
class Field:
    """A named, typed column in a schema."""

    name: str
    type: DataType


@dataclasses.dataclass(frozen=True)
class Schema:
    """Ordered column metadata for a chunk or table."""

    fields: tuple[Field, ...]

    def __post_init__(self):
        if not isinstance(self.fields, tuple):
            object.__setattr__(self, "fields", tuple(self.fields))

    @staticmethod
    def of(*cols: tuple[str, DataType]) -> "Schema":
        return Schema(tuple(Field(n, t) for n, t in cols))

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, i: int) -> Field:
        return self.fields[i]

    @property
    def types(self) -> tuple[DataType, ...]:
        return tuple(f.type for f in self.fields)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    def select(self, indices) -> "Schema":
        return Schema(tuple(self.fields[i] for i in indices))

    def concat(self, other: "Schema") -> "Schema":
        return Schema(self.fields + other.fields)
