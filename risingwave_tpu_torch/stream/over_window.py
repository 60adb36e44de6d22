"""OverWindow executors: window functions over partitions.

Counterpart of ``risingwave_tpu/stream/over_window.py``: the general
(retractable) OverWindowExecutor and the append-only, emit-on-window-close
EowcOverWindowExecutor. Functions: row_number / rank / dense_rank, lag(k) /
lead(k) (general only), and the running sum / count / min / max / avg with
the PG default frame (RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW:
peers included; the whole partition without ORDER BY).

Host tier, as in the reference: window maintenance is control flow over
per-partition caches, sparse in its output. The rows arrive as device
chunks, are applied on the host, and leave as chunks on ``device``.

* ``OverWindowExecutor`` keeps each partition's rows sorted by (order key,
  pk) with per-position values and accumulators, recomputes at a barrier
  only the suffix from the first changed position, and diffs it against
  the output emitted before (Delete, Insert, U-/U+ pairs; every Delete of
  the barrier first).
* ``EowcOverWindowExecutor`` takes watermark-sorted append-only input (a
  SortExecutor upstream) through per-partition running accumulators and
  emits each row once, when its peer group closes. Its accumulator and
  buffer tables have the reference's row layout (``eowc_acc_schema``), so
  a store snapshot interchanges.

VARCHAR order columns compare by string, never by id or rank (``_RevStr``
for DESC).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Optional, Sequence

from .. import DEFAULT_DEVICE
from ..common.chunk import (
    DEFAULT_CHUNK_CAPACITY, OP_DELETE, OP_INSERT, OP_UPDATE_DELETE,
    OP_UPDATE_INSERT, StreamChunk, chunk_to_rows, make_chunk,
)
from ..common.types import GLOBAL_STRING_DICT, INT64, DataType, Field, Schema
from ..ops.topn import OrderSpec
from ..storage.state_table import StateTable
from .executor import Executor, SingleInputExecutor
from .message import Barrier, Watermark

AGG_WINDOW_KINDS = {"sum", "count", "min", "max", "avg"}
RANK_KINDS = {"row_number", "rank", "dense_rank"}


@dataclasses.dataclass(frozen=True)
class WindowCall:
    """One window function over the shared (partition_by, order_by) frame.
    ``arg`` indexes the operator's input schema (-1 = none)."""

    kind: str
    output_type: DataType
    arg: int = -1
    offset: int = 1                    # lag/lead distance
    partition_by: tuple = ()           # input col indices
    order_by: tuple = ()               # OrderSpec over input cols


class _RevStr(str):
    """A str comparing in REVERSE lexicographic order — lets DESC string
    order keys live inside ordinary ascending-sorted tuples."""

    __slots__ = ()

    def __lt__(self, o):
        return str.__gt__(self, o)

    def __le__(self, o):
        return str.__ge__(self, o)

    def __gt__(self, o):
        return str.__lt__(self, o)

    def __ge__(self, o):
        return str.__le__(self, o)


def _order_key(row, order_by: Sequence[OrderSpec]):
    """Sortable key implementing desc + nulls placement per spec. VARCHAR
    order columns compare by STRING CONTENT, never raw id — and never by
    dictionary *rank* either: ranks renumber as new strings intern, so a
    rank baked into a stored sort key goes stale (the incremental
    executor keeps keys across barriers)."""
    key = []
    for spec in order_by:
        v = row[spec.col] if spec.col < len(row) else None
        null_rank = 1 if spec.nulls_last else -1
        if v is None:
            key.append((null_rank, 0))
        elif spec.is_string:
            s = GLOBAL_STRING_DICT.lookup(int(v))
            key.append((0, _RevStr(s) if spec.desc else s))
        else:
            key.append((0, -v if spec.desc else v))
    return tuple(key)


def _sort_partition(rows: list, order_by, pk_indices) -> list:
    return sorted(rows, key=lambda r: (
        _order_key(r, order_by), tuple(r[i] for i in pk_indices)))


def _agg_step(kind: str, acc, v):
    if v is None:
        return acc
    cnt, s, mn, mx = acc
    return (cnt + 1, (s or 0) + v,
            v if mn is None else min(mn, v),
            v if mx is None else max(mx, v))


def _agg_value(kind: str, acc, out_type: DataType):
    cnt, s, mn, mx = acc
    if kind == "count":
        return cnt
    if kind == "sum":
        return None if cnt == 0 else s
    if kind == "min":
        return mn
    if kind == "max":
        return mx
    if kind == "avg":
        return None if cnt == 0 else (
            s / cnt if out_type.is_float else s // cnt)
    raise AssertionError(kind)


def compute_window_values(rows: list, calls: Sequence[WindowCall],
                          pk_indices) -> dict:
    """Full recompute for one partition: {pk: (win values…)} — the host
    model the executors and tests share. ``rows`` are physical tuples."""
    if not rows:
        return {}
    order_by = calls[0].order_by
    srows = _sort_partition(rows, order_by, pk_indices)
    n = len(srows)
    keys = [_order_key(r, order_by) for r in srows]
    # peer groups: [start, end) spans of equal order key
    group_of = [0] * n
    g = 0
    for i in range(1, n):
        if keys[i] != keys[i - 1]:
            g += 1
        group_of[i] = g
    group_start = {}
    group_end = {}
    for i in range(n):
        group_start.setdefault(group_of[i], i)
        group_end[group_of[i]] = i + 1

    out_cols = []
    for c in calls:
        vals: list = [None] * n
        if c.kind == "row_number":
            vals = [i + 1 for i in range(n)]
        elif c.kind == "rank":
            vals = [group_start[group_of[i]] + 1 for i in range(n)]
        elif c.kind == "dense_rank":
            vals = [group_of[i] + 1 for i in range(n)]
        elif c.kind == "lag":
            vals = [srows[i - c.offset][c.arg] if i - c.offset >= 0 else None
                    for i in range(n)]
        elif c.kind == "lead":
            vals = [srows[i + c.offset][c.arg] if i + c.offset < n else None
                    for i in range(n)]
        elif c.kind in AGG_WINDOW_KINDS:
            acc = (0, None, None, None)

            def arg_of(r, _c=c):
                # count(*) (arg=-1) counts every row; others skip NULL args
                return 1 if _c.arg < 0 else r[_c.arg]

            if not order_by:
                for r in srows:
                    acc = _agg_step(c.kind, acc, arg_of(r))
                v = _agg_value(c.kind, acc, c.output_type)
                vals = [v] * n
            else:
                # RANGE ... CURRENT ROW: value at end of own peer group
                per_group_val = {}
                for gi in sorted(group_end):
                    for i in range(group_start[gi], group_end[gi]):
                        acc = _agg_step(c.kind, acc, arg_of(srows[i]))
                    per_group_val[gi] = _agg_value(c.kind, acc, c.output_type)
                vals = [per_group_val[group_of[i]] for i in range(n)]
        else:
            raise ValueError(f"unsupported window function {c.kind}")
        out_cols.append(vals)
    return {
        tuple(srows[i][j] for j in pk_indices):
            tuple(col[i] for col in out_cols)
        for i in range(n)
    }


def _emit_chunks(schema: Schema, pairs: list, out_capacity: int, device):
    """pairs: list of (op, physical_row); U-/U+ pairs kept adjacent and
    never split across chunk boundaries."""
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


class _Partition:
    """Sorted partition state for incremental maintenance: entries kept in
    (order-key, pk) order with per-position value/accumulator snapshots so
    a barrier recomputes only the suffix from the first changed position
    (the reference's delta-neighborhood idea, delta_btree_map.rs)."""

    __slots__ = ("entries", "vals", "accs", "dense")

    def __init__(self):
        self.entries: list = []     # (sortkey, row); sortkey=(okey, pk)
        self.vals: list = []        # aligned output tuples
        self.accs: list = []        # aligned tuple-of-acc per agg call
        self.dense: list = []       # aligned 0-based dense-group ordinal


class OverWindowExecutor(SingleInputExecutor):
    """General (retractable) over-window with **incremental** maintenance:
    per-barrier work is O(delta · log n + affected-suffix), not
    O(partition) (VERDICT r4 weak #6; reference:
    over_window/delta_btree_map.rs). Rows before the first changed
    order-key position keep their values — window functions with the PG
    default frame only ever read the prefix — so for in-order (event-time
    ascending) streams the suffix IS the delta. Output schema = input ⧺
    window columns."""

    identity = "OverWindow"

    def __init__(self, input: Executor, calls: Sequence[WindowCall],
                 pk_indices: Sequence[int],
                 state_table: Optional[StateTable] = None,
                 out_capacity: int = DEFAULT_CHUNK_CAPACITY,
                 device=DEFAULT_DEVICE):
        super().__init__(input)
        self.device = device
        self.calls = tuple(calls)
        self.pk_indices = tuple(pk_indices)
        self.schema = Schema(tuple(input.schema) + tuple(
            Field(f"_win{i}", c.output_type)
            for i, c in enumerate(self.calls)))
        self.in_schema = input.schema
        self.state_table = state_table
        self.out_capacity = out_capacity
        self._part_cols = self.calls[0].partition_by
        self._order_by = self.calls[0].order_by
        self._max_lead = max(
            (c.offset for c in self.calls if c.kind == "lead"), default=0)
        self._agg_idx = [i for i, c in enumerate(self.calls)
                        if c.kind in AGG_WINDOW_KINDS]
        self._parts: dict[tuple, _Partition] = {}
        self._pk_loc: dict[tuple, tuple] = {}   # pk -> (part, sortkey)
        self._out: dict[tuple, dict] = {}   # part -> {pk: (row, vals)}
        #: per-barrier change tracking
        self._min_key: dict[tuple, tuple] = {}   # part -> min touched key
        self._removed: dict[tuple, set] = {}     # part -> pks deleted
        #: count of positions recomputed since construction (microbench /
        #: introspection hook proving O(delta) behavior)
        self.positions_recomputed = 0
        if state_table is not None:
            for row in state_table.scan_all():
                self._apply_row(OP_INSERT, tuple(row))
            for part in list(self._min_key):
                self._recompute_and_diff(part)   # discard initial diff
            self._min_key.clear()
            self._removed.clear()

    def _part_of(self, row) -> tuple:
        return tuple(row[i] for i in self._part_cols)

    def _sortkey(self, row: tuple) -> tuple:
        return (_order_key(row, self._order_by),
                tuple(row[i] for i in self.pk_indices))

    def _note(self, part: tuple, key: tuple) -> None:
        cur = self._min_key.get(part)
        if cur is None or key < cur:
            self._min_key[part] = key

    def _apply_row(self, op: int, row: tuple) -> None:
        pk = tuple(row[i] for i in self.pk_indices)
        part = self._part_of(row)
        key = self._sortkey(row)
        if op in (OP_INSERT, OP_UPDATE_INSERT):
            loc = self._pk_loc.get(pk)
            if loc is not None:
                # upsert: a bare INSERT for a live pk replaces its row —
                # possibly in a DIFFERENT partition (the pre-incremental
                # executor's contract)
                self._drop_entry(pk, *loc)
                self._removed.setdefault(loc[0], set()).add(pk)
            p = self._parts.get(part)
            if p is None:
                p = self._parts[part] = _Partition()
            pos = bisect.bisect_left(p.entries, key, key=lambda e: e[0])
            p.entries.insert(pos, (key, row))
            p.vals.insert(pos, None)
            p.accs.insert(pos, None)
            p.dense.insert(pos, -1)
            self._pk_loc[pk] = (part, key)
            self._removed.get(part, set()).discard(pk)
            self._note(part, key)
        else:
            loc = self._pk_loc.pop(pk, None)
            if loc is None:
                return                     # delete of unknown row
            self._drop_entry(pk, *loc)
            self._removed.setdefault(loc[0], set()).add(pk)

    def _drop_entry(self, pk: tuple, part: tuple, key: tuple) -> None:
        p = self._parts.get(part)
        if p is None:
            return
        pos = bisect.bisect_left(p.entries, key, key=lambda e: e[0])
        if pos < len(p.entries) and p.entries[pos][0] == key:
            del p.entries[pos], p.vals[pos], p.accs[pos], p.dense[pos]
        self._note(part, key)

    async def map_chunk(self, chunk: StreamChunk):
        for op, row in chunk_to_rows(chunk, self.in_schema, with_ops=True,
                                     physical=True):
            self._apply_row(op, tuple(row))
            if self.state_table is not None:
                if op in (OP_INSERT, OP_UPDATE_INSERT):
                    self.state_table.insert(row)
                else:
                    self.state_table.delete(row)
        if False:
            yield

    # -- incremental recompute ------------------------------------------------

    def _start_pos(self, p: _Partition, min_key: tuple) -> int:
        n = len(p.entries)
        start = bisect.bisect_left(p.entries, min_key, key=lambda e: e[0])
        start = max(0, start - self._max_lead)
        start = min(start, n)
        # back up to the start of the peer group (rank/agg values are
        # shared across peers; the group containing the first change
        # recomputes wholesale)
        while 0 < start < n and p.entries[start - 1][0][0] == \
                p.entries[start][0][0]:
            start -= 1
        if start == n and n > 0:
            # change strictly beyond the end (deletion of the old tail):
            # the surviving tail's lead()s looked past it — recompute the
            # last peer group + lead reach
            start = max(0, n - 1 - self._max_lead)
            while 0 < start and p.entries[start - 1][0][0] == \
                    p.entries[start][0][0]:
                start -= 1
        return start

    def _recompute_suffix(self, p: _Partition, start: int) -> None:
        """Recompute vals/accs/dense for positions [start, n)."""
        n = len(p.entries)
        self.positions_recomputed += n - start
        if start > 0:
            prev_accs = p.accs[start - 1]
            prev_dense = p.dense[start - 1]
        else:
            prev_accs = tuple((0, None, None, None) for _ in self._agg_idx)
            prev_dense = -1
        rows = p.entries
        calls = self.calls
        # group-close assignment: collect the open peer group's positions,
        # assign agg values when the key changes
        group_positions: list = []
        group_start = start

        def close_group(end_accs):
            for gi in group_positions:
                vals = list(p.vals[gi])
                for aj, ci in enumerate(self._agg_idx):
                    vals[ci] = _agg_value(calls[ci].kind, end_accs[aj],
                                          calls[ci].output_type)
                p.vals[gi] = tuple(vals)

        accs = prev_accs
        dense = prev_dense
        for i in range(start, n):
            okey = rows[i][0][0]
            new_group = (i == start) or okey != rows[i - 1][0][0]
            if new_group:
                if group_positions:
                    close_group(accs)
                group_positions = []
                group_start = i
                dense += 1
            row = rows[i][1]
            new_accs = []
            for aj, ci in enumerate(self._agg_idx):
                c = calls[ci]
                v = 1 if c.arg < 0 else row[c.arg]
                new_accs.append(_agg_step(c.kind, accs[aj], v))
            accs = tuple(new_accs)
            p.accs[i] = accs
            p.dense[i] = dense
            vals = []
            for ci, c in enumerate(calls):
                if c.kind == "row_number":
                    vals.append(i + 1)
                elif c.kind == "rank":
                    vals.append(group_start + 1)
                elif c.kind == "dense_rank":
                    vals.append(dense + 1)
                elif c.kind == "lag":
                    j = i - c.offset
                    vals.append(rows[j][1][c.arg] if j >= 0 else None)
                elif c.kind == "lead":
                    j = i + c.offset
                    vals.append(rows[j][1][c.arg] if j < n else None)
                else:
                    vals.append(None)       # agg: assigned at group close
            p.vals[i] = tuple(vals)
            group_positions.append(i)
        if group_positions:
            close_group(accs)
        # (lead() needs no extra pass: _start_pos already backed up by
        # _max_lead, so every position whose lead target changed is INSIDE
        # the recomputed suffix)

    def _recompute_and_diff(self, part: tuple) -> tuple:
        """Returns (deletes, others) op/out_row pair lists for one dirty
        partition and updates the emitted-output cache. Deletes are
        separated so the barrier can emit ALL deletes first — a pk moving
        between partitions must retract from its old partition before the
        new partition's insert reaches the downstream pk-keyed state."""
        p = self._parts.get(part)
        out = self._out.setdefault(part, {})
        deletes: list = []
        others: list = []
        min_key = self._min_key[part]
        removed = self._removed.pop(part, set())
        if p is None or not p.entries:
            self._parts.pop(part, None)
            for pk, (row, vals) in out.items():
                deletes.append((OP_DELETE, row + vals))
            self._out.pop(part, None)
            return deletes, others
        start = self._start_pos(p, min_key)
        self._recompute_suffix(p, start)
        live_suffix_pks = set()
        for i in range(start, len(p.entries)):
            key, row = p.entries[i]
            pk = key[1]
            live_suffix_pks.add(pk)
            vals = p.vals[i]
            old = out.get(pk)
            if old is None:
                others.append((OP_INSERT, row + vals))
            elif old != (row, vals):
                others.append((OP_UPDATE_DELETE, old[0] + old[1]))
                others.append((OP_UPDATE_INSERT, row + vals))
            out[pk] = (row, vals)
        for pk in removed:
            if pk not in live_suffix_pks and pk in out:
                row, vals = out.pop(pk)
                deletes.append((OP_DELETE, row + vals))
        return deletes, others

    async def on_barrier(self, barrier: Barrier):
        deletes: list = []
        others: list = []
        for part in sorted(self._min_key, key=repr):
            d, o = self._recompute_and_diff(part)
            deletes.extend(d)
            others.extend(o)
        self._min_key.clear()
        self._removed.clear()
        for chunk in _emit_chunks(self.schema, deletes + others,
                                  self.out_capacity, self.device):
            yield chunk
        if self.state_table is not None:
            self.state_table.commit(barrier.epoch.curr)


def eowc_acc_schema(in_schema: Schema, calls: Sequence[WindowCall]) -> Schema:
    """Accumulator-table schema for the EOWC executor: partition key cols
    ⧺ (n, last_order, rank_last, dense_last) ⧺ per-call (cnt, sum, min, max)."""
    part = calls[0].partition_by
    fields = [Field(f"p{i}", in_schema[c].type) for i, c in enumerate(part)]
    fields += [Field("_n", INT64), Field("_last_ord", INT64),
               Field("_rank_last", INT64), Field("_dense_last", INT64)]
    for i, c in enumerate(calls):
        arg_t = in_schema[c.arg].type if c.arg >= 0 else INT64
        sum_t = c.output_type if c.kind in ("sum", "avg") else arg_t
        fields += [Field(f"c{i}_cnt", INT64), Field(f"c{i}_sum", sum_t),
                   Field(f"c{i}_min", arg_t), Field(f"c{i}_max", arg_t)]
    return Schema(tuple(fields))


class EowcOverWindowExecutor(SingleInputExecutor):
    """Append-only over-window with emit-on-window-close semantics
    (reference: over_window/eowc.rs). Input must arrive sorted by the
    order column (SortExecutor upstream) and append-only; each row is
    emitted exactly once, when its peer group closes (a later order value
    arrives, or the watermark passes it at a barrier)."""

    identity = "EowcOverWindow"

    def __init__(self, input: Executor, calls: Sequence[WindowCall],
                 pk_indices: Sequence[int],
                 acc_table: Optional[StateTable] = None,
                 buffer_table: Optional[StateTable] = None,
                 out_capacity: int = DEFAULT_CHUNK_CAPACITY,
                 device=DEFAULT_DEVICE):
        super().__init__(input)
        self.device = device
        self.calls = tuple(calls)
        for c in self.calls:
            if c.kind not in RANK_KINDS | AGG_WINDOW_KINDS:
                raise ValueError(
                    f"{c.kind} is not emit-on-window-close capable")
        if not self.calls[0].order_by:
            raise ValueError("EOWC over-window requires ORDER BY")
        self.order_col = self.calls[0].order_by[0].col
        self.pk_indices = tuple(pk_indices)
        self.schema = Schema(tuple(input.schema) + tuple(
            Field(f"_win{i}", c.output_type)
            for i, c in enumerate(self.calls)))
        self.in_schema = input.schema
        self.out_capacity = out_capacity
        self.acc_table = acc_table
        self.buffer_table = buffer_table
        self._part_cols = self.calls[0].partition_by
        # part -> {"n", "last_ord", "rank_last", "dense_last", "accs": [...]}
        self._accs: dict[tuple, dict] = {}
        self._pending: dict[tuple, list] = {}     # open peer group rows
        self._wm: Optional[int] = None
        self._emit_buf: list = []
        if acc_table is not None:
            npart = len(self._part_cols)
            for row in acc_table.scan_all():
                part = tuple(row[:npart])
                st = {"n": row[npart], "last_ord": row[npart + 1],
                      "rank_last": row[npart + 2],
                      "dense_last": row[npart + 3], "accs": []}
                base = npart + 4
                for i in range(len(self.calls)):
                    st["accs"].append(tuple(row[base + 4 * i:base + 4 * i + 4]))
                self._accs[part] = st
        if buffer_table is not None:
            for row in buffer_table.scan_all():
                part = tuple(row[i] for i in self._part_cols)
                self._pending.setdefault(part, []).append(tuple(row))

    def _flush_group(self, part: tuple) -> None:
        """Close the open peer group: run it through the accumulators and
        emit its rows."""
        rows = self._pending.pop(part, None)
        if not rows:
            return
        rows = _sort_partition(rows, self.calls[0].order_by, self.pk_indices)
        st = self._accs.setdefault(part, {
            "n": 0, "last_ord": None, "rank_last": 0, "dense_last": 0,
            "accs": [(0, None, None, None)] * len(self.calls)})
        n0 = st["n"]
        rank = n0 + 1
        dense = st["dense_last"] + 1
        # aggregates: whole peer group folds in before any row's value
        # (RANGE frame includes peers)
        for i, c in enumerate(self.calls):
            if c.kind in AGG_WINDOW_KINDS:
                acc = st["accs"][i]
                for r in rows:
                    acc = _agg_step(c.kind, acc,
                                    1 if c.arg < 0 else r[c.arg])
                st["accs"][i] = acc
        for j, r in enumerate(rows):
            vals = []
            for i, c in enumerate(self.calls):
                if c.kind == "row_number":
                    vals.append(n0 + j + 1)
                elif c.kind == "rank":
                    vals.append(rank)
                elif c.kind == "dense_rank":
                    vals.append(dense)
                else:
                    vals.append(_agg_value(c.kind, st["accs"][i],
                                           c.output_type))
            self._emit_buf.append((OP_INSERT, r + tuple(vals)))
            if self.buffer_table is not None:
                self.buffer_table.delete(r)
        st["n"] = n0 + len(rows)
        st["last_ord"] = rows[-1][self.order_col]
        st["rank_last"] = rank
        st["dense_last"] = dense

    async def map_chunk(self, chunk: StreamChunk):
        for op, row in chunk_to_rows(chunk, self.in_schema, with_ops=True,
                                     physical=True):
            if op != OP_INSERT:
                raise AssertionError(
                    "EOWC over-window requires append-only input")
            row = tuple(row)
            part = self._part_of(row)
            pend = self._pending.get(part)
            if pend and row[self.order_col] != pend[0][self.order_col]:
                if row[self.order_col] < pend[0][self.order_col]:
                    raise AssertionError(
                        "EOWC over-window input not sorted by order column")
                self._flush_group(part)
            self._pending.setdefault(part, []).append(row)
            if self.buffer_table is not None:
                self.buffer_table.insert(row)
        for chunk_out in self._drain_emit():
            yield chunk_out

    def _part_of(self, row) -> tuple:
        return tuple(row[i] for i in self._part_cols)

    def _drain_emit(self):
        buf, self._emit_buf = self._emit_buf, []
        yield from _emit_chunks(self.schema, buf, self.out_capacity,
                                self.device)

    async def on_watermark(self, watermark: Watermark):
        if watermark.col_idx == self.order_col:
            self._wm = watermark.value
        yield watermark

    async def on_barrier(self, barrier: Barrier):
        # peer groups strictly below the watermark can never grow again
        # (rows with ts >= wm may still arrive; ts < wm were dropped
        # upstream by the WatermarkFilter): close them now
        if self._wm is not None:
            for part in list(self._pending):
                rows = self._pending[part]
                if rows and rows[0][self.order_col] < self._wm:
                    self._flush_group(part)
        for chunk in self._drain_emit():
            yield chunk
        epoch = barrier.epoch.curr
        if self.acc_table is not None:
            for part, st in self._accs.items():
                row = list(part) + [st["n"], st["last_ord"],
                                    st["rank_last"], st["dense_last"]]
                for acc in st["accs"]:
                    row.extend(acc)
                self.acc_table.insert(tuple(row))
            self.acc_table.commit(epoch)
        if self.buffer_table is not None:
            self.buffer_table.commit(epoch)
