"""MaterializedAggExecutor — host-tier aggregation over materialized input
multisets.

Counterpart of ``risingwave_tpu/stream/materialized_agg.py``: aggregates
whose state cannot be a fixed set of device lanes keep their input values
materialized per (group, call) and recompute outputs from the multiset —
exact DISTINCT aggregates, min/max over a retractable input (a delete may
remove the current extremum), and the collecting kinds (array_agg,
string_agg, percentile_cont, mode). These are ragged by nature, like
VARCHAR contents, so they live on the host; the planner routes an agg here
only when a call requires it, with its sibling calls: an
approx_count_distinct among them is evaluated exactly, as the multiset's
distinct count. array_agg gives its elements in ascending order of their
python values, NULL elements last, interned into ``GLOBAL_LIST_DICT``.

State is one value multiset (Counter) per (group, call), persisted to a
StateTable as (group_key…, agg_idx, is_null, val_i, val_f, val_s) → count
rows, so recovery rebuilds the exact multisets. VARCHAR, BYTEA and JSONB
values ride the ``_val_s`` column, which persists string content, not
dictionary ids. LIST and STRUCT arguments are rejected: their ids are
process-local and no value column holds their content, so persisted ids
would miscount after recovery.
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence

from .. import DEFAULT_DEVICE
from ..common.chunk import (
    DEFAULT_CHUNK_CAPACITY, OP_DELETE, OP_INSERT, OP_UPDATE_DELETE,
    OP_UPDATE_INSERT, StreamChunk, chunk_to_rows, make_chunk,
)
from ..common.types import (
    FLOAT64, GLOBAL_LIST_DICT, GLOBAL_STRING_DICT, INT64, VARCHAR, Field,
    Schema,
)
from ..expr.agg import AggCall
from ..storage.state_table import StateTable
from .executor import Executor, SingleInputExecutor
from .message import Barrier

MATERIALIZED_KINDS = AggCall.MATERIALIZED_KINDS


def call_needs_materialized(c: AggCall, input_append_only: bool) -> bool:
    """Does this call force the materialized-input executor?"""
    if c.lanes_unsupported:
        return True
    return c.kind in ("min", "max") and not input_append_only


def materialized_agg_state_schema(key_fields: Sequence[Field]) -> Schema:
    """Durable multiset row: group key ⧺ (agg_idx, is_null, val_i, val_f,
    val_s, cnt). agg_idx == -1 carries the group's row count (a group whose
    agg args are all NULL must still exist)."""
    return Schema(tuple(key_fields) + (
        Field("_agg_idx", INT64), Field("_is_null", INT64),
        Field("_val_i", INT64), Field("_val_f", FLOAT64),
        Field("_val_s", VARCHAR), Field("_cnt", INT64),
    ))


def emit_chunks(schema: Schema, pairs: list, out_capacity: int,
                device=DEFAULT_DEVICE):
    """Chunks of (op, physical_row) pairs; a U-/U+ pair is never split
    across two chunks."""
    i = 0
    while i < len(pairs):
        take = pairs[i:i + out_capacity]
        if (take and take[-1][0] == OP_UPDATE_DELETE
                and i + len(take) < len(pairs)):
            take = take[:-1]
        i += len(take)
        yield make_chunk(schema, [r for _, r in take],
                         ops=[op for op, _ in take],
                         capacity=max(out_capacity, len(take)),
                         device=device, physical=True)


class _GroupState:
    __slots__ = ("total", "counters", "null_counts")

    def __init__(self, n_calls: int):
        self.total = 0                                  # live rows in group
        self.counters = [collections.Counter() for _ in range(n_calls)]
        self.null_counts = [0] * n_calls


def _by_text(i: int) -> str:
    return GLOBAL_STRING_DICT.lookup(i)


class MaterializedAggExecutor(SingleInputExecutor):
    """Group-by aggregation with per-group materialized value multisets.
    ``group_keys == ()`` is global (single-group) aggregation."""

    identity = "MaterializedAgg"

    def __init__(self, input: Executor, group_keys: Sequence[int],
                 agg_calls: Sequence[AggCall],
                 state_table: Optional[StateTable] = None,
                 out_capacity: int = DEFAULT_CHUNK_CAPACITY,
                 load_vnodes: Optional[tuple] = None,
                 device=DEFAULT_DEVICE):
        """``load_vnodes``: (vnode_start, vnode_end): recovery reloads only
        the groups in that vnode range."""
        super().__init__(input)
        self.group_keys = tuple(group_keys)
        self.load_vnodes = load_vnodes
        self.agg_calls = tuple(agg_calls)
        for c in self.agg_calls:
            if c.arg_type is not None and (c.arg_type.is_list
                                           or c.arg_type.is_struct):
                raise ValueError(
                    f"{c.kind}() over an array column is not supported"
                    if c.arg_type.is_list else
                    f"{c.kind}() over a struct column is not supported")
        self.in_schema = input.schema
        self.state_table = state_table
        self.out_capacity = out_capacity
        self.device = device
        key_fields = tuple(self.in_schema[i] for i in self.group_keys)
        self.schema = Schema(key_fields + tuple(
            Field(f"agg{i}", c.output_type)
            for i, c in enumerate(self.agg_calls)))
        #: per call: 'f' float, 's' string, 'i' everything else — the
        #: durable value column that carries the multiset value
        self._arg_class = [
            "f" if (c.arg_type is not None and c.arg_type.is_float)
            else "s" if (c.arg_type is not None and c.arg_type.is_string)
            else "i"
            for c in self.agg_calls]
        self._groups: dict[tuple, _GroupState] = {}
        self._out: dict[tuple, tuple] = {}        # group -> last emitted row
        self._dirty: set = set()
        #: groups whose multiset changed since the last persisted snapshot
        self._ckpt_dirty: set = set()
        if state_table is not None:
            self._load_from_state_table()
        if not self.group_keys and () not in self._groups:
            # global aggregation always has its one group: the MV shows
            # count = 0 / NULLs before any input and after full retraction
            self._groups[()] = _GroupState(len(self.agg_calls))
            self._dirty.add(())
            self._ckpt_dirty.add(())

    # -- input ----------------------------------------------------------------

    async def map_chunk(self, chunk: StreamChunk):
        for op, row in chunk_to_rows(chunk, self.in_schema, with_ops=True,
                                     physical=True):
            self._apply_row(op, row)
        if False:
            yield

    def _apply_row(self, op: int, row: tuple) -> None:
        key = tuple(row[i] for i in self.group_keys)
        sign = 1 if op in (OP_INSERT, OP_UPDATE_INSERT) else -1
        g = self._groups.get(key)
        if g is None:
            if sign < 0:
                raise RuntimeError(
                    f"materialized agg: delete for unknown group {key}")
            g = self._groups[key] = _GroupState(len(self.agg_calls))
        g.total += sign
        for i, c in enumerate(self.agg_calls):
            if c.arg < 0:            # count(*): no multiset needed
                continue
            v = row[c.arg]
            if v is None:
                g.null_counts[i] += sign
                continue
            g.counters[i][v] += sign
            if g.counters[i][v] == 0:
                del g.counters[i][v]
            elif g.counters[i][v] < 0:
                raise RuntimeError(
                    "materialized agg: negative multiplicity for value "
                    f"{v!r} in group {key} (unpaired retraction)")
        if g.total < 0:
            raise RuntimeError(
                f"materialized agg: negative row count in group {key}")
        self._dirty.add(key)
        self._ckpt_dirty.add(key)

    # -- outputs --------------------------------------------------------------

    def _eval_call(self, i: int, c: AggCall, g: _GroupState):
        """The physical value (or None) of call i over the group multiset."""
        counter = g.counters[i]
        is_str = c.arg_type is not None and c.arg_type.is_string
        if c.kind == "count":
            if c.arg < 0:
                return g.total
            if c.distinct:
                return len(counter)
            return sum(counter.values())
        if c.kind == "approx_count_distinct":
            # routed here beside a sibling that needs the multiset: the
            # exact distinct count meets the approximate contract
            return len(counter)
        if c.kind == "array_agg":
            # ascending by python value (an order PostgreSQL leaves
            # unspecified), the NULL elements last; NULLs alone still
            # aggregate
            if not counter and not g.null_counts[i]:
                return None
            conv = c.arg_type.to_python
            out: list = []
            for v, n in sorted((conv(v), n) for v, n in counter.items()):
                out.extend([v] * n)
            out.extend([None] * g.null_counts[i])
            return GLOBAL_LIST_DICT.intern(out)
        if not counter:
            return None              # every arg NULL (or the group empty)
        if c.kind == "sum":
            if c.distinct:
                return sum(counter.keys())
            return sum(v * n for v, n in counter.items())
        if c.kind == "avg":
            if c.distinct:
                return float(sum(counter.keys())) / len(counter)
            n = sum(counter.values())
            return float(sum(v * m for v, m in counter.items())) / n
        if c.kind in ("min", "max"):
            pick = min if c.kind == "min" else max
            # dictionary ids are insertion-ordered: compare contents
            return pick(counter.keys(), key=_by_text if is_str else None)
        if c.kind == "mode":
            # the most frequent value; ties go to the smallest value
            maxn = max(counter.values())
            cands = [v for v, n in counter.items() if n == maxn]
            return min(cands, key=_by_text if is_str else None)
        if c.kind == "percentile_cont":
            frac = float(c.extra if c.extra is not None else 0.5)
            vals: list = []
            for v, n in sorted(counter.items()):
                vals.extend([v] * n)
            idx = frac * (len(vals) - 1)
            lo = int(idx)
            hi = min(lo + 1, len(vals) - 1)
            return vals[lo] + (vals[hi] - vals[lo]) * (idx - lo)
        if c.kind == "string_agg":
            delim = c.extra if c.extra is not None else ""
            parts: list = []
            for v, n in sorted(counter.items(),
                               key=lambda kv: _by_text(kv[0])):
                parts.extend([_by_text(v)] * n)
            return GLOBAL_STRING_DICT.intern(delim.join(parts))
        raise ValueError(f"unsupported materialized agg kind {c.kind!r}")

    def _group_row(self, key: tuple, g: _GroupState) -> tuple:
        return key + tuple(self._eval_call(i, c, g)
                           for i, c in enumerate(self.agg_calls))

    async def on_barrier(self, barrier: Barrier):
        pairs: list = []
        for key in sorted(self._dirty, key=repr):
            g = self._groups.get(key)
            old = self._out.get(key)
            if (g is None or g.total == 0) and self.group_keys:
                self._groups.pop(key, None)
                if old is not None:
                    pairs.append((OP_DELETE, old))
                    del self._out[key]
                continue
            if g is None:                     # the global group never dies
                g = self._groups[key] = _GroupState(len(self.agg_calls))
            new = self._group_row(key, g)
            if old is None:
                pairs.append((OP_INSERT, new))
            elif old != new:
                pairs.append((OP_UPDATE_DELETE, old))
                pairs.append((OP_UPDATE_INSERT, new))
            self._out[key] = new
        self._dirty.clear()
        for chunk in emit_chunks(self.schema, pairs, self.out_capacity,
                                 self.device):
            yield chunk
        if barrier.checkpoint and self.state_table is not None:
            self._checkpoint(barrier.epoch.curr)

    # -- persistence ----------------------------------------------------------

    def _state_rows(self, key: tuple, g: _GroupState) -> list:
        rows = [key + (-1, 0, 0, 0.0, 0, g.total)]
        for i, c in enumerate(self.agg_calls):
            if c.arg < 0:
                continue
            if g.null_counts[i]:
                rows.append(key + (i, 1, 0, 0.0, 0, g.null_counts[i]))
            cls = self._arg_class[i]
            for v, n in g.counters[i].items():
                if cls == "f":
                    rows.append(key + (i, 0, 0, float(v), 0, n))
                elif cls == "s":
                    rows.append(key + (i, 0, 0, 0.0, int(v), n))
                else:
                    rows.append(key + (i, 0, int(v), 0.0, 0, n))
        return rows

    def _checkpoint(self, epoch: int) -> None:
        st = self.state_table
        for key in self._ckpt_dirty:
            # multiset rows are keyed by value: stale counts must go
            # explicitly, so the group is rewritten whole
            for row in st.scan_prefix(key, len(self.group_keys)):
                st.delete(row)
            g = self._groups.get(key)
            if g is not None and (g.total > 0 or not self.group_keys):
                for row in self._state_rows(key, g):
                    st.insert(row)
        self._ckpt_dirty.clear()
        st.commit(epoch)

    def _load_from_state_table(self) -> None:
        nk = len(self.group_keys)
        rows = list(self.state_table.scan_all())
        if rows and nk and self.load_vnodes is not None:
            from ..common.hashing import filter_rows_vnodes
            key_types = [self.in_schema[i].type for i in self.group_keys]
            s, e = self.load_vnodes
            rows = filter_rows_vnodes(key_types, rows, s, e)
        for row in rows:
            key = tuple(row[:nk])
            agg_idx, is_null, val_i, val_f, val_s, cnt = row[nk:nk + 6]
            g = self._groups.get(key)
            if g is None:
                g = self._groups[key] = _GroupState(len(self.agg_calls))
            if agg_idx == -1:
                g.total = cnt
            elif is_null:
                g.null_counts[agg_idx] = cnt
            else:
                cls = self._arg_class[agg_idx]
                v = val_f if cls == "f" else val_s if cls == "s" else val_i
                g.counters[agg_idx][v] = cnt
        for key, g in self._groups.items():
            self._out[key] = self._group_row(key, g)
