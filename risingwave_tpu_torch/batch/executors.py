"""Batch executors: one-shot query operators over snapshots.

Counterpart of ``risingwave_tpu/batch/executors.py``. A scan turns a state
table's rows into chunks on the device once; filter, project, hash agg and
hash join run on those chunks; rows come back to the host only at the
presentation edge (sort, limit, output). The hash agg is the streaming
engine's ``AggCore`` (its group table is kernel B3); the hash join builds a
one-shot table of the build side's keys (B3's find-or-insert) and probes it
(B3's find). Unique build keys take one lane per key; duplicate keys retry
the build at 8x the bucket width, and past ``MAX_BUCKET_W`` the join raises
``BatchFallback``, on which the Session runs the SELECT through the stream
fold. The overflow checks read a flag back to the host, which a one-shot
query can afford.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import (
    Column, StreamChunk, chunk_to_rows, physical_chunk,
)
from ..common.types import GLOBAL_STRING_DICT, Field, Schema
from ..expr.agg import AggCall
from ..expr.expr import Expr
from ..ops.grouped_agg import AggCore
from ..ops.hash_table import ht_lookup, ht_lookup_or_insert, ht_new
from ..ops.topn import OrderSpec
from ..storage.state_table import StateTable
from ..stream.simple_agg import _AggLanes


class BatchFallback(Exception):
    """Raised at run time when a plan shape needs the streaming fold
    (a join build side past the bucket budget, an agg table overflow)."""


def _rows_chunk(cols: Sequence[tuple], device) -> StreamChunk:
    """A chunk of ``n`` visible insert rows from (data, mask) pairs."""
    n = cols[0][0].shape[0] if cols else 1
    return StreamChunk(torch.zeros(n, dtype=torch.int8, device=device),
                       torch.ones(n, dtype=torch.bool, device=device),
                       tuple(Column(d, m) for d, m in cols))


class BatchExecutor:
    schema: Schema

    def execute_chunks(self) -> Iterator[StreamChunk]:
        """Yields chunks on the device (visibility-masked)."""
        raise NotImplementedError

    def execute(self) -> Iterator[List[tuple]]:
        """Row view (physical tuples): the presentation edge."""
        for chunk in self.execute_chunks():
            rows = chunk_to_rows(chunk, self.schema, physical=True)
            if rows:
                yield rows


class _SingleInput(BatchExecutor):
    def __init__(self, input: BatchExecutor):
        self.input = input
        self.schema = input.schema


class RowSeqScan(BatchExecutor):
    """Snapshot scan of a state table, in chunks of ``batch_size`` rows.
    ``prefix``: values of the first len(prefix) pk columns, restricting the
    scan to that key range (the index lookup)."""

    def __init__(self, table: StateTable, batch_size: int = 4096,
                 prefix: Optional[Sequence] = None, device=DEFAULT_DEVICE):
        self.table = table
        self.schema = table.schema
        self.batch_size = batch_size
        self.prefix = None if prefix is None else list(prefix)
        self.device = device

    def execute_chunks(self):
        it = (self.table.scan_all() if self.prefix is None
              else self.table.scan_prefix(self.prefix, len(self.prefix)))
        buf: List[tuple] = []
        for row in it:
            buf.append(row)
            if len(buf) >= self.batch_size:
                yield physical_chunk(self.schema, buf, len(buf), self.device)
                buf = []
        if buf:
            yield physical_chunk(self.schema, buf, len(buf), self.device)


class BatchRows(BatchExecutor):
    """Physical rows from a provider callable."""

    def __init__(self, schema: Schema, provider, batch_size: int = 4096,
                 device=DEFAULT_DEVICE):
        self.schema = schema
        self.provider = provider
        self.batch_size = batch_size
        self.device = device

    def execute_chunks(self):
        rows = self.provider()
        for i in range(0, len(rows), self.batch_size):
            part = rows[i:i + self.batch_size]
            yield physical_chunk(self.schema, part, len(part), self.device)


class BatchFilter(_SingleInput):
    def __init__(self, input: BatchExecutor, predicate: Expr):
        super().__init__(input)
        self.predicate = predicate

    def execute_chunks(self):
        for chunk in self.input.execute_chunks():
            cond = self.predicate.eval(chunk)
            yield chunk.mask_vis(cond.data & cond.mask)


class BatchProject(_SingleInput):
    def __init__(self, input: BatchExecutor, exprs: Sequence[Expr],
                 names: Sequence[str] = ()):
        super().__init__(input)
        self.exprs = list(exprs)
        names = tuple(names) or tuple(f"expr{i}" for i in range(len(exprs)))
        self.schema = Schema(tuple(
            Field(n, e.type) for n, e in zip(names, self.exprs)))

    def execute_chunks(self):
        for chunk in self.input.execute_chunks():
            yield chunk.with_columns([e.eval(chunk) for e in self.exprs])


def _str_ranks(calls: Sequence[AggCall], device):
    if not any(c.is_string_minmax for c in calls):
        return None
    return GLOBAL_STRING_DICT.device_ranks(device)


class BatchHashAgg(_SingleInput):
    """One-shot grouped or global aggregation: the streaming AggCore's
    group table (kernel B3) and lanes over the whole snapshot, then one
    output chunk of the live groups."""

    def __init__(self, input: BatchExecutor, group_keys: Sequence[int],
                 agg_calls: Sequence[AggCall],
                 table_capacity: int = 1 << 16, device=DEFAULT_DEVICE):
        super().__init__(input)
        self.group_keys = tuple(group_keys)
        self.agg_calls = tuple(agg_calls)
        self.schema = Schema(tuple(input.schema[i] for i in self.group_keys)
                             + tuple(Field(f"agg{i}", a.output_type)
                                     for i, a in enumerate(self.agg_calls)))
        self.capacity = table_capacity
        self.device = torch.device(device)
        if self.group_keys:
            key_types = tuple(input.schema[i].type for i in self.group_keys)
            self.core = AggCore(key_types, self.group_keys, self.agg_calls,
                                table_capacity, out_capacity=1024,
                                device=device)
        else:
            self.lanes_def = _AggLanes(self.agg_calls)

    def execute_chunks(self):
        dev = self.device
        if not self.group_keys:
            # one row even over no input (count 0, the rest NULL)
            lanes = self.lanes_def.init_lanes(dev)
            for chunk in self.input.execute_chunks():
                ranks = _str_ranks(self.agg_calls, dev)
                lanes = self.lanes_def.merge(
                    lanes, self.lanes_def.chunk_deltas(chunk, ranks), ranks)
            yield _rows_chunk([(d.reshape(1), m.reshape(1))
                               for d, m in self.lanes_def.outputs(lanes)],
                              dev)
            return
        state = self.core.init_state()
        for chunk in self.input.execute_chunks():
            state = self.core.apply_chunk(
                state, chunk, str_ranks=_str_ranks(self.agg_calls, dev))
        if bool(state.overflow):
            raise BatchFallback(
                f"batch agg table overflow (capacity {self.capacity})")
        idx = torch.nonzero(state.table.occupied
                            & (state.lanes[0] > 0)).reshape(-1)
        if not len(idx):
            return
        cols = [(d[idx], m[idx]) for d, m in zip(state.table.key_data,
                                                 state.table.key_mask)]
        cols += [(d[idx], m[idx]) for d, m in self.core.outputs(state.lanes)]
        yield _rows_chunk(cols, dev)


def _occurrence(slots: torch.Tensor, keyed: torch.Tensor,
                cap: int) -> torch.Tensor:
    """For each keyed row, the number of earlier keyed rows of the chunk
    with its slot (a stable sort by slot, then the position in the run)."""
    s = torch.where(keyed, slots, torch.full_like(slots, cap))
    order = torch.argsort(s, stable=True)
    ss = s[order]
    pos = torch.arange(ss.shape[0], device=ss.device)
    start = torch.ones_like(ss, dtype=torch.bool)
    start[1:] = ss[1:] != ss[:-1]
    run0 = torch.cummax(torch.where(start, pos, torch.zeros_like(pos)),
                        0).values
    occ = torch.empty_like(pos)
    occ[order] = pos - run0
    return occ


class BatchHashJoin(BatchExecutor):
    """One-shot hash join: inner, left, right, full outer, left semi and
    left anti.

    The build side's rows go to ``cap·W`` lanes, up to W rows per key
    (W = 1, the unique layout of a join against a pk side; duplicate keys
    retry at 8x W, the bucketed layout). Each probe row gathers the W
    lanes of its key. RIGHT joins build the left side and probe the right;
    FULL outer keeps a matched flag per build lane and emits the unmatched
    build rows at the end."""

    MAX_BUCKET_W = 512
    #: build lanes (cap·W) held on the device per trial build
    LANE_BUDGET = 1 << 22

    def __init__(self, left: BatchExecutor, right: BatchExecutor,
                 left_keys: Sequence[int], right_keys: Sequence[int],
                 join_type: str = "inner",
                 condition: Optional[Expr] = None,
                 table_capacity: int = 1 << 16,
                 prefer_build: str = "right",
                 null_aware: bool = False,
                 device=DEFAULT_DEVICE):
        if join_type not in ("inner", "left", "right", "full",
                             "left_semi", "left_anti"):
            raise BatchFallback(f"batch join type {join_type!r}")
        self.left, self.right = left, right
        self.left_keys = tuple(left_keys)
        self.right_keys = tuple(right_keys)
        self.join_type = join_type
        self.condition = condition
        #: NOT IN: a NULL key on the build (subquery) side passes no row
        self.null_aware = null_aware and join_type == "left_anti"
        self.capacity = table_capacity
        self.device = torch.device(device)
        if join_type == "inner":
            self.prefer_build = prefer_build
        else:
            self.prefer_build = "left" if join_type == "right" else "right"
        if join_type in ("left_semi", "left_anti"):
            self.schema = Schema(tuple(left.schema))
        else:
            self.schema = Schema(tuple(left.schema) + tuple(right.schema))

    def _cap_for(self, W: int) -> int:
        cap = min(self.capacity, max(1024, self.LANE_BUDGET // W))
        p = 1
        while p * 2 <= cap:
            p *= 2
        return p

    def _sides(self, swapped: bool):
        """(build side, its keys, probe side, its keys)."""
        if swapped:
            return self.left, self.left_keys, self.right, self.right_keys
        return self.right, self.right_keys, self.left, self.left_keys

    def _try_build(self, swapped: bool, W: int, chunks: list):
        side, build_keys, _, _ = self._sides(swapped)
        cap, dev = self._cap_for(W), self.device
        table = ht_new(tuple(side.schema[i].type for i in build_keys), cap,
                       dev)
        # one spare slot at the end takes the dropped rows
        counts = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
        datas = [torch.zeros(cap * W + 1, dtype=f.type.dtype, device=dev)
                 for f in side.schema]
        masks = [torch.zeros(cap * W + 1, dtype=torch.bool, device=dev)
                 for _ in side.schema]
        bad = torch.zeros((), dtype=torch.bool, device=dev)
        for chunk in chunks:
            key_cols = [chunk.columns[i] for i in build_keys]
            # NULL join keys never match: such build rows are skipped
            keyed = chunk.vis
            for c in key_cols:
                keyed = keyed & c.mask
            table, slots, _, ovf = ht_lookup_or_insert(table, key_cols,
                                                       keyed)
            pos = counts[slots.clamp(0, cap - 1)] \
                + _occurrence(slots, keyed, cap)
            bad = bad | ovf | (keyed & (pos >= W)).any()
            idx = torch.where(keyed & (pos < W), slots * W + pos,
                              torch.full_like(slots, cap * W))
            for acc, m, c in zip(datas, masks, chunk.columns):
                acc[idx] = c.data
                m[idx] = c.mask
            counts.index_add_(0, torch.where(keyed, slots,
                                             torch.full_like(slots, cap)),
                              keyed.long())
        if bool(bad):
            return None
        return table, counts[:cap], datas, masks

    def _probe(self, built, swapped: bool, W: int, matched, chunk):
        table, counts, datas, masks = built
        _, _, _, probe_keys = self._sides(swapped)
        cap = self._cap_for(W)
        key_cols = [chunk.columns[i] for i in probe_keys]
        keyed = chunk.vis
        for c in key_cols:
            keyed = keyed & c.mask
        slots, found = ht_lookup(table, key_cols, keyed)
        found = found & keyed
        safe = slots.clamp(0, cap - 1)
        n = found.shape[0]
        lane = torch.arange(W, device=self.device)
        flat = (safe[:, None] * W + lane[None, :]).reshape(n * W)
        cand = ((lane[None, :] < counts[safe][:, None])
                & found[:, None]).reshape(n * W)
        vis_rep = chunk.vis.repeat_interleave(W)
        ops_rep = chunk.ops.repeat_interleave(W)
        bcols = tuple(Column(d[flat], m[flat] & cand)
                      for d, m in zip(datas, masks))
        pcols = tuple(Column(c.data.repeat_interleave(W),
                             c.mask.repeat_interleave(W))
                      for c in chunk.columns)
        # columns in schema order (left ++ right), whichever side was built
        wide = StreamChunk(ops_rep, vis_rep,
                           (bcols + pcols) if swapped else (pcols + bcols))
        match = cand
        if self.condition is not None:
            c = self.condition.eval(wide)
            match = cand & c.data & c.mask
        match = match & vis_rep
        row_any = match.reshape(n, W).any(1)
        lane0 = (torch.arange(n * W, device=self.device) % W) == 0
        matched[torch.where(match, flat, torch.full_like(flat, cap * W))] = \
            True
        if self.join_type in ("left_semi", "left_anti"):
            keep = (row_any if self.join_type == "left_semi"
                    else ~row_any).repeat_interleave(W)
            return StreamChunk(ops_rep, vis_rep & lane0 & keep, pcols)
        if self.join_type in ("left", "right", "full"):
            # a pad row (no match left) carries NULL build columns
            pad = lane0 & (~row_any).repeat_interleave(W)
            b_nulled = tuple(Column(c.data, c.mask & match) for c in bcols)
            return StreamChunk(
                ops_rep, match | (vis_rep & pad),
                (b_nulled + pcols) if swapped else (pcols + b_nulled))
        return wide.replace(vis=match)

    def _nulls(self, schema: Schema, n: int) -> tuple:
        return tuple(Column(torch.zeros(n, dtype=f.type.dtype,
                                        device=self.device),
                            torch.zeros(n, dtype=torch.bool,
                                        device=self.device))
                     for f in schema)

    def execute_chunks(self):
        swapped = self.prefer_build == "left"
        build_side, build_keys, probe_side, _ = self._sides(swapped)
        build_chunks = list(build_side.execute_chunks())
        built, W = None, 1
        while built is None and W <= self.MAX_BUCKET_W:
            built = self._try_build(swapped, W, build_chunks)
            if built is None:
                W *= 8
        if built is None:
            raise BatchFallback(
                "batch hash join build side exceeds the bucket budget "
                f"(> {self.MAX_BUCKET_W} rows per key or too many keys); "
                "falling back to the streaming join")

        def unkeyed(chunk):
            keyed = chunk.vis
            for i in build_keys:
                keyed = keyed & chunk.columns[i].mask
            return chunk.vis & ~keyed

        if self.null_aware and any(bool(unkeyed(c).any())
                                   for c in build_chunks):
            return      # x NOT IN (..., NULL) is never true
        null_keyed = []
        if self.join_type == "full":
            # NULL-keyed build rows match nothing but are still emitted
            for chunk in build_chunks:
                u = unkeyed(chunk)
                if bool(u.any()):
                    nulls = self._nulls(probe_side.schema, chunk.capacity)
                    cols = chunk.columns
                    null_keyed.append(StreamChunk(
                        chunk.ops, u,
                        (cols + nulls) if swapped else (nulls + cols)))
        del build_chunks
        cap = self._cap_for(W)
        matched = torch.zeros(cap * W + 1, dtype=torch.bool,
                              device=self.device)
        for chunk in probe_side.execute_chunks():
            yield self._probe(built, swapped, W, matched, chunk)
        if self.join_type != "full":
            return
        yield from null_keyed
        _, counts, datas, masks = built
        lane_no = torch.arange(cap * W, device=self.device) % W
        vis = (lane_no < counts.repeat_interleave(W)) & ~matched[:cap * W]
        piece = 1 << 16
        for lo in range(0, cap * W, piece):
            hi = min(lo + piece, cap * W)
            pv = vis[lo:hi]
            if not bool(pv.any()):
                continue
            pb = tuple(Column(d[lo:hi], m[lo:hi] & pv)
                       for d, m in zip(datas, masks))
            nulls = self._nulls(probe_side.schema, hi - lo)
            yield StreamChunk(
                torch.zeros(hi - lo, dtype=torch.int8, device=self.device),
                pv, (pb + nulls) if swapped else (nulls + pb))


def _host_order_key(t):
    """A host sort key of one physical value of type ``t``: the value, or
    a VARCHAR's dictionary rank (ids are in insertion order)."""
    if t is None or not t.is_string:
        return lambda v: v
    ranks = GLOBAL_STRING_DICT.ranks()
    return lambda v: int(ranks[v])


class BatchSort(_SingleInput):
    """Presentation edge: an output-sized sort of the rows on the host."""

    def __init__(self, input: BatchExecutor, order: Sequence[OrderSpec]):
        super().__init__(input)
        self.order = list(order)

    def execute_chunks(self):  # pragma: no cover - row-based operator
        raise NotImplementedError("BatchSort is a row-edge operator")

    def execute(self):
        allrows = [r for rows in self.input.execute() for r in rows]
        keyfns = [_host_order_key(self.input.schema[s.col].type)
                  for s in self.order]

        def key(row):
            k = []
            for spec, kf in zip(self.order, keyfns):
                v = row[spec.col]
                null_rank = 1 if spec.nulls_last else -1
                k.append((null_rank, 0) if v is None
                         else (0, -kf(v) if spec.desc else kf(v)))
            return tuple(k)

        allrows.sort(key=key)
        if allrows:
            yield allrows


class BatchLimit(_SingleInput):
    def __init__(self, input: BatchExecutor, limit: int, offset: int = 0):
        super().__init__(input)
        self.limit = limit
        self.offset = offset

    def execute_chunks(self):  # pragma: no cover - row-based operator
        raise NotImplementedError("BatchLimit is a row-edge operator")

    def execute(self):
        skipped = taken = 0
        for rows in self.input.execute():
            out = []
            for r in rows:
                if skipped < self.offset:
                    skipped += 1
                    continue
                if taken >= self.limit:
                    break
                out.append(r)
                taken += 1
            if out:
                yield out
            if taken >= self.limit:
                return


def run_batch(root: BatchExecutor) -> List[tuple]:
    """A batch plan's whole result (physical rows)."""
    return [r for rows in root.execute() for r in rows]
