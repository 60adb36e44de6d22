"""Logical type system for the data plane.

Counterpart of ``risingwave_tpu/common/types.py``: every logical type lowers
to a fixed-width tensor dtype. This package carries the scalar types of the
NEXmark q5/q7 path. VARCHAR is dictionary-encoded at the ingest boundary: the
device sees int32 ids into the host's process-wide ``GLOBAL_STRING_DICT``,
which ``to_physical`` interns into and ``to_python`` looks up.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Any

import numpy as np
import torch


class TypeKind(enum.Enum):
    BOOL = "boolean"
    INT32 = "int"
    INT64 = "bigint"
    FLOAT64 = "double"
    TIMESTAMP = "timestamp"    # int64 microseconds since epoch
    VARCHAR = "varchar"        # int32 dictionary id


_PHYSICAL: dict[TypeKind, torch.dtype] = {
    TypeKind.BOOL: torch.bool,
    TypeKind.INT32: torch.int32,
    TypeKind.INT64: torch.int64,
    TypeKind.FLOAT64: torch.float64,
    TypeKind.TIMESTAMP: torch.int64,
    TypeKind.VARCHAR: torch.int32,
}

_NP_OF_TORCH = {torch.bool: np.bool_, torch.int32: np.int32,
                torch.int64: np.int64, torch.float64: np.float64}

_INTEGRAL = {TypeKind.INT32, TypeKind.INT64, TypeKind.TIMESTAMP}


class StringDict:
    """Host-side dictionary for VARCHAR columns.

    Interning happens on the ingest path and decoding on the egress path;
    device code only compares, hashes or moves the int32 ids. Id 0 is the
    empty string, so zero-initialised buffers decode cleanly. Growth is
    bounded by ``max_size``: hitting it is a capacity-planning error raised
    loudly. Ids are insertion-ordered, so no ordering operation may use
    them raw; they never cross a process boundary (the durable row format
    in ``row.py`` stores the string bytes)."""

    __slots__ = ("_to_id", "_to_str", "max_size", "_lock")

    DEFAULT_MAX = 1 << 22          # 4M distinct strings

    def __init__(self, max_size: int = DEFAULT_MAX) -> None:
        self._lock = threading.Lock()
        self._to_id: dict[str, int] = {"": 0}
        self._to_str: list[str] = [""]
        self.max_size = max_size

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
        return i

    def lookup(self, i: int) -> str:
        return self._to_str[i]

    def __len__(self) -> int:
        return len(self._to_str)


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
    """A logical column type."""

    kind: TypeKind

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
        return self.kind == TypeKind.FLOAT64

    @property
    def is_string(self) -> bool:
        return self.kind == TypeKind.VARCHAR

    def to_physical(self, v: Any) -> Any:
        """Python value → physical scalar for device buffers."""
        if v is None:
            return self.null_sentinel()
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
INT32 = DataType(TypeKind.INT32)
INT64 = DataType(TypeKind.INT64)
FLOAT64 = DataType(TypeKind.FLOAT64)
TIMESTAMP = DataType(TypeKind.TIMESTAMP)
VARCHAR = DataType(TypeKind.VARCHAR)


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

    def concat(self, other: "Schema") -> "Schema":
        return Schema(self.fields + other.fields)
