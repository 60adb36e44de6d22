"""Session: the SQL entry point over a single-process, in-memory cluster.

Counterpart of the core of ``risingwave_tpu/frontend/session.py``: the
statements (CREATE SOURCE / TABLE / MATERIALIZED VIEW, DROP, INSERT,
UPDATE, DELETE, SELECT, EXPLAIN, SHOW, FLUSH) and the epoch conductor.
``tick`` feeds the sources, drains staged DML into the epoch, injects a
barrier into every source and table queue and completes the oldest epoch
in flight (committing the store, with the sources' split offsets, on a
checkpoint epoch). A SELECT is planned, lowered to the batch engine and
run over the committed state; a shape the batch engine does not take runs
the stream fold: the same operators over snapshot sources, the change
stream folded into rows.

Meta, workers, the serving plane, UDFs, tracing, co-scheduling, the tick
compiler, mesh sharding and durable stores are not here: CREATE SINK,
CREATE INDEX, SET and ALTER SYSTEM, and the configurations that ask for
the others, raise ``SqlError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
import decimal as _decimal
from typing import Any, Callable, Optional

import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import (
    OP_DELETE, OP_INSERT, OP_UPDATE_DELETE, OP_UPDATE_INSERT, Column,
    StreamChunk, chunk_to_rows, make_chunk, physical_chunk,
)
from ..common.types import (
    INT64, SERIAL, VARCHAR, Field, Schema, TypeKind,
)
from ..connector.factory import (
    DEBEZIUM_NEEDS_PK, ConnectorError, make_reader,
)
from ..connector.nexmark import AUCTION_SCHEMA, BID_SCHEMA, PERSON_SCHEMA
from ..expr.expr import InputRef, Literal, cast
from ..storage.state_table import StateTable
from ..stream.eowc import WatermarkFilterExecutor
from ..stream.executor import Executor
from ..stream.materialize import MaterializeExecutor
from ..stream.message import Barrier, Message, Mutation, MutationKind
from ..stream.row_id_gen import RowIdGenExecutor
from ..stream.source import MockSource
from . import sqlast as A
from .binder import ExprBinder, Scope
from .build import BuildConfig, BuildContext, build_plan
from .catalog import (
    Catalog, MaterializedViewDef, SourceDef, TableDef, strip_schema,
    type_from_name,
)
from .optimizer import optimize
from .parser import parse_sql
from .planner import Planner, PlanError, PMvScan, PSource, PTableScan, \
    PValues
from .runtime import JobRuntime, QueueSource, StreamJob


class SqlError(ValueError):
    pass


#: statements and settings of later slices, with the ROADMAP item of each
_LATER = {
    A.CreateSink: "CREATE SINK is ROADMAP A6 part 2",
    A.CreateIndex: "CREATE INDEX is ROADMAP A6 part 2",
    A.SetStatement: "SET and ALTER SYSTEM are ROADMAP A6 part 2",
}


def _values_chunk(leaf: PValues, device) -> StreamChunk:
    """VALUES rows as one chunk: a non-literal expression is evaluated over
    a one-row chunk with no columns."""
    one = StreamChunk(torch.zeros(1, dtype=torch.int8, device=device),
                      torch.ones(1, dtype=torch.bool, device=device), ())
    rows = []
    for r in leaf.rows:
        vals = []
        for e in r:
            if isinstance(e, Literal):
                vals.append(e.value)
            else:
                c = e.eval(one)
                vals.append(e.type.to_python(c.data[0].item())
                            if bool(c.mask[0]) else None)
        rows.append(tuple(vals))
    return make_chunk(leaf.schema, rows, capacity=max(len(rows), 1),
                      device=device)


def _decimal_physical(v: Any, scale: int) -> int:
    """A literal as a DECIMAL column of ``scale`` stores it: rounded half
    away from zero at the scale, from the literal's own digits
    (PostgreSQL's numeric input)."""
    q = _decimal.Decimal(repr(v) if isinstance(v, float) else str(v))
    q = q.scaleb(scale).quantize(_decimal.Decimal(1),
                                 rounding=_decimal.ROUND_HALF_UP)
    return int(q)


@dataclasses.dataclass
class _SourceFeed:
    """A connector instance feeding one job's source leaf. ``reader`` and
    ``state_table`` carry the split offsets, recorded per injected epoch
    and persisted with each checkpoint epoch's commit."""

    queue: QueueSource
    generator: Callable[[], Optional[StreamChunk]]
    reader: Optional[Any] = None
    state_table: Optional[StateTable] = None
    offsets_at_epoch: dict = dataclasses.field(default_factory=dict)
    job: str = ""          # owning stream job; the feed dies with it


class _RowIdAppendSource(Executor):
    """A queue of connector chunks, each with the hidden ``_row_id`` column
    appended for RowIdGen to fill."""

    def __init__(self, inner: QueueSource, out_schema: Schema):
        self.inner = inner
        self.schema = out_schema

    async def execute(self):
        async for msg in self.inner.execute():
            if isinstance(msg, StreamChunk):
                rid = Column(torch.zeros_like(msg.vis, dtype=torch.int64),
                             torch.ones_like(msg.vis))
                yield msg.with_columns(msg.columns + (rid,))
            else:
                yield msg


class Session(JobRuntime):
    """The catalog, the state store, the stream jobs and the epoch clock of
    one process. Every executor it builds is on ``device``."""

    def __init__(self, checkpoint_frequency: int = 10,
                 chunks_per_tick: int = 1, source_chunk_capacity: int = 1024,
                 config: Optional[BuildConfig] = None, seed: int = 42,
                 in_flight_barriers: int = 1, device=DEFAULT_DEVICE):
        self.config = config or BuildConfig()
        super().__init__(device=device, chunk_capacity=source_chunk_capacity,
                         batch_rows=self.config.backfill_batch_rows)
        self.catalog = Catalog()
        self.checkpoint_frequency = checkpoint_frequency
        self.chunks_per_tick = chunks_per_tick
        self.source_chunk_capacity = source_chunk_capacity
        self.seed = seed
        self.in_flight_barriers = max(1, in_flight_barriers)
        self.feeds: list[_SourceFeed] = []
        self._inflight: list[tuple[int, bool]] = []   # (epoch, checkpoint)
        self._injected = self.epoch                   # last injected epoch
        self._pending_mutation: Optional[Mutation] = None
        self._next_shard = 0

    def next_table_id(self) -> int:
        return self.catalog.next_table_id()

    # ------------------------------------------------------------ statements

    def run_sql(self, sql: str) -> list:
        """Execute statements; returns the last statement's result rows."""
        out: list = []
        for stmt in parse_sql(sql):
            out = self._run_statement(stmt)
        return out

    def _run_statement(self, stmt: A.Statement) -> list:
        for kind, why in _LATER.items():
            if isinstance(stmt, kind):
                raise SqlError(why)
        if isinstance(stmt, (A.CreateSource, A.CreateTable,
                             A.CreateMaterializedView)):
            # a failed CREATE must not shift later statements' table ids
            saved_id = self.catalog._next_table_id
            try:
                if isinstance(stmt, A.CreateSource):
                    return self._create_source(stmt)
                if isinstance(stmt, A.CreateTable):
                    return self._create_table(stmt)
                return self._create_mv(stmt)
            except BaseException:
                self.catalog._next_table_id = saved_id
                raise
        if isinstance(stmt, A.DropStatement):
            return self._drop(stmt)
        if isinstance(stmt, A.Insert):
            return self._insert(stmt)
        if isinstance(stmt, A.Delete):
            return self._delete_dml(stmt)
        if isinstance(stmt, A.Update):
            return self._update_dml(stmt)
        if isinstance(stmt, A.Query):
            return self.query(stmt.select)
        if isinstance(stmt, A.ShowStatement):
            reg = {"tables": self.catalog.tables,
                   "sources": self.catalog.sources,
                   "sinks": self.catalog.sinks,
                   "indexes": self.catalog.indexes,
                   "materialized_views": self.catalog.mvs}.get(stmt.what)
            if reg is None:
                raise SqlError(f"cannot SHOW {stmt.what}")
            return [(name,) for name in sorted(reg)]
        if isinstance(stmt, A.Explain):
            return self._explain(stmt)
        if isinstance(stmt, A.FlushStatement):
            self.flush()
            return []
        raise SqlError(f"unsupported statement {type(stmt).__name__}")

    # ------------------------------------------------------------------- DDL

    def _create_source(self, stmt: A.CreateSource) -> list:
        if stmt.if_not_exists and stmt.name in self.catalog.sources:
            return []
        connector = str(stmt.with_options.get("connector", ""))
        fmt = str(stmt.with_options.get("format", "")).lower()
        if fmt in ("debezium", "debezium_json"):
            raise SqlError(DEBEZIUM_NEEDS_PK)
        if connector == "nexmark":
            table = str(stmt.with_options.get(
                "nexmark_table", stmt.with_options.get("table", "bid")))
            schema = {"bid": BID_SCHEMA, "auction": AUCTION_SCHEMA,
                      "person": PERSON_SCHEMA}[table.lower()]
            if stmt.columns:
                missing = {c.name for c in stmt.columns} - set(schema.names)
                if missing:
                    raise SqlError(
                        f"columns {missing} not in nexmark {table}")
        elif stmt.columns:
            schema = Schema(tuple(
                Field(c.name, type_from_name(c.type_name))
                for c in stmt.columns))
        else:
            raise SqlError(
                "CREATE SOURCE requires columns or a known connector")
        watermark = None
        if stmt.watermark is not None:
            watermark = self._bind_watermark(stmt.watermark, schema)
        self.catalog.add_source(SourceDef(
            stmt.name, schema, connector, dict(stmt.with_options),
            watermark=watermark))
        return []

    def _bind_watermark(self, wm_ast, schema: Schema):
        col_name, expr = wm_ast
        try:
            idx = list(schema.names).index(col_name)
        except ValueError:
            raise SqlError(f"watermark column {col_name!r} not found")
        # the one supported shape: col - INTERVAL 'x'
        if (isinstance(expr, A.BinaryOp) and expr.op == "-"
                and isinstance(expr.left, A.ColumnRef)
                and expr.left.name == col_name
                and isinstance(expr.right, A.Lit)):
            return (idx, int(expr.right.value))
        raise SqlError("watermark must be '<col> - INTERVAL ...'")

    def _alloc_row_id_start(self) -> int:
        """A RowIdGen's first id: ``shard << 48``, one shard per source
        leaf or keyless table, as the reference numbers them."""
        self._next_shard += 1
        return (self._next_shard - 1) << 48

    def _create_table(self, stmt: A.CreateTable) -> list:
        if stmt.if_not_exists and stmt.name in self.catalog.tables:
            return []
        self._drain_inflight()
        self.catalog._check_free(stmt.name)
        fields = tuple(Field(c.name, type_from_name(c.type_name))
                       for c in stmt.columns)
        schema = Schema(fields)
        names = list(schema.names)
        if stmt.pk:
            pk = tuple(names.index(c) for c in stmt.pk)
        else:
            # a table without a pk gets the hidden _row_id
            schema = Schema(fields + (Field("_row_id", SERIAL),))
            pk = (len(fields),)
        t = TableDef(stmt.name, schema, pk,
                     table_id=self.catalog.next_table_id(),
                     append_only=stmt.append_only)
        self.catalog.add_table(t)
        # the table is a stream job: DML queue -> (RowIdGen) -> Materialize
        q = QueueSource(Schema(fields))
        src: Executor = q
        if not stmt.pk:
            src = RowIdGenExecutor(_RowIdAppendSource(q, schema),
                                   row_id_index=len(fields),
                                   start_seq=self._alloc_row_id_start(),
                                   device=self.device)
        self.start_table_job(stmt.name, t.table_id, q, src, schema, pk)
        return []

    def _plan(self, query: A.Select):
        """Parse tree → bound, planned and optimized plan."""
        return optimize(Planner(self.catalog, session=self)
                        .plan_select(query))

    def _explain(self, stmt: A.Explain) -> list:
        inner = stmt.stmt
        if isinstance(inner, A.Query):
            sel = inner.select
        elif isinstance(inner, A.CreateMaterializedView):
            sel = inner.query
        else:
            raise SqlError(f"cannot EXPLAIN {type(inner).__name__}")
        return [(line,) for line in self._plan(sel).explain().split("\n")]

    def _check_config(self) -> None:
        cfg = self.config
        if cfg.mesh is not None:
            raise SqlError("mesh-sharded MVs are ROADMAP A5 (multi-GPU)")
        if cfg.coschedule or cfg.tick_compiler:
            raise SqlError("co-scheduled and tick-compiled MVs are "
                           "ROADMAP A4 (multi-job fusion)")

    def _create_mv(self, stmt: A.CreateMaterializedView) -> list:
        if stmt.if_not_exists and stmt.name in self.catalog.mvs:
            return []
        self._check_config()
        self._drain_inflight()      # subscribe at a quiesced epoch boundary
        self.catalog._check_free(stmt.name)
        n_feeds0 = len(self.feeds)
        plan = self._plan(stmt.query)
        queues: list[QueueSource] = []
        init_msgs: list[tuple[QueueSource, list[Message]]] = []

        def factory(leaf) -> Executor:
            ex, q, init = self._stream_leaf(leaf)
            queues.append(q)
            init_msgs.append((q, init))
            return ex

        ctx = BuildContext(self.store, self.catalog.next_table_id, factory,
                           self.config, durable=True, device=self.device)
        try:
            pipeline = build_plan(plan, ctx)
        except BaseException:
            # the leaves built so far: no feed or upstream bus keeps them
            del self.feeds[n_feeds0:]
            for bf in self._pending:
                for job in self.jobs.values():
                    job.bus.unsubscribe(bf.input)
            self._pending = []
            raise
        mv_table_id = self.catalog.next_table_id()
        mat = MaterializeExecutor(
            pipeline,
            StateTable(self.store, mv_table_id, plan.schema, list(plan.pk)))
        mv = MaterializedViewDef(stmt.name, plan.schema, tuple(plan.pk),
                                 table_id=mv_table_id)
        mv.n_visible = sum(1 for f in plan.schema
                           if not f.name.startswith("_"))
        mv.state_table_ids = tuple(ctx.state_table_ids)
        self.catalog.add_mv(mv)
        for f in self.feeds[n_feeds0:]:
            f.job = stmt.name
        self.backfills[stmt.name], self._pending = self._pending, []
        # the next barrier announces the new job
        self._pending_mutation = Mutation(MutationKind.ADD, stmt.name)
        # the init cut: each leaf's queue takes its init rows
        self.start_job(StreamJob(stmt.name, mat, queues), init_msgs)
        return []

    def _stream_leaf(self, leaf):
        """-> (executor, its queue, init messages)"""
        if isinstance(leaf, PSource):
            src_def = leaf.source
            q = QueueSource(src_def.schema)
            try:
                reader = make_reader(src_def.connector, src_def.options,
                                     src_def.schema,
                                     self.source_chunk_capacity, self.seed,
                                     device=self.device)
            except ConnectorError as e:
                raise SqlError(str(e)) from None
            if reader is None:
                self.feeds.append(_SourceFeed(q, lambda: None))
            else:
                # split-state table: (split_id, next_offset)
                st = StateTable(
                    self.store, self.catalog.next_table_id(),
                    Schema((Field("split_id", VARCHAR),
                            Field("next_offset", INT64))), [0])
                self.feeds.append(_SourceFeed(
                    q, reader.next_chunk, reader=reader, state_table=st))
            ex: Executor = RowIdGenExecutor(
                _RowIdAppendSource(q, leaf.schema),
                row_id_index=leaf.row_id_index,
                start_seq=self._alloc_row_id_start(), device=self.device)
            if src_def.watermark is not None:
                col, delay = src_def.watermark
                ex = WatermarkFilterExecutor(ex, time_col=col, delay=delay,
                                             device=self.device)
            return ex, q, []
        if isinstance(leaf, (PTableScan, PMvScan)):
            name = (leaf.table.name if isinstance(leaf, PTableScan)
                    else leaf.mv.name)
            # a Backfill over the upstream's state table, fed its deltas;
            # its queue takes only the init barrier from here
            bf = self.scan(name)
            return bf, bf.input, []
        if isinstance(leaf, PValues):
            # a feed with no rows, so that every barrier reaches the leaf
            # (the reference's VALUES leaf takes only the init barrier,
            # and its job then never completes another epoch)
            q = QueueSource(leaf.schema)
            self.feeds.append(_SourceFeed(q, lambda: None))
            return q, q, [_values_chunk(leaf, self.device)]
        raise PlanError(f"cannot stream {type(leaf).__name__}")

    def _unsubscribe_job(self, job: StreamJob) -> None:
        for other in self.jobs.values():
            if other is not job:
                for q in job.sources:
                    other.bus.unsubscribe(q)

    def _drop(self, stmt: A.DropStatement) -> list:
        if stmt.kind == "index":
            raise SqlError("indexes are ROADMAP A6 part 2")
        self._drain_inflight()
        obj = (self.catalog.tables.get(stmt.name)
               or self.catalog.mvs.get(stmt.name))
        if not self.catalog.drop(stmt.kind, stmt.name, stmt.if_exists):
            return []
        # the job's own tables: its feeds' split states and its Backfills'
        # progress (the reference leaves the latter in the store)
        own = [f.state_table for f in self.feeds if f.job == stmt.name]
        own += [bf.progress_table for bf in self.backfills.pop(stmt.name, [])]
        job = self.jobs.pop(stmt.name, None)
        if job is not None:
            self._await(job.stop())
            self._unsubscribe_job(job)
            self.feeds = [f for f in self.feeds if f.job != stmt.name]
            self.table_queues = [q for q in self.table_queues
                                 if q not in job.sources]
        for st in own:
            if st is not None:
                self.store.drop_table(st.table_id)
        if obj is not None:
            self.dml.unregister_table(obj.table_id)
            for tid in ((obj.table_id,)
                        + tuple(getattr(obj, "state_table_ids", ()))):
                self.store.drop_table(tid)
        return []

    # ------------------------------------------------------------------- DML

    def _insert(self, stmt: A.Insert) -> list:
        t = self.catalog.tables.get(strip_schema(stmt.table))
        if t is None:
            raise SqlError(f"table {stmt.table!r} not found")
        binder = ExprBinder(Scope([]))
        fields = [f for f in t.schema if f.name != "_row_id"]
        names = [f.name for f in fields]
        cols = list(stmt.columns) or names

        def phys(v, ty):
            if v is None:
                return None
            if ty.kind == TypeKind.DECIMAL:
                return _decimal_physical(v, ty.scale)
            return ty.to_physical(v)

        rows = []
        for vrow in stmt.rows:
            if len(vrow) != len(cols):
                raise SqlError("INSERT arity mismatch")
            by_name = {}
            for cname, vexpr in zip(cols, vrow):
                lit = binder.bind(vexpr)
                if not isinstance(lit, Literal):
                    raise SqlError("INSERT values must be literals")
                by_name[cname] = lit.value
            rows.append(tuple(phys(by_name.get(f.name), f.type)
                              for f in fields))
        schema = Schema(tuple(fields))
        cap = self.source_chunk_capacity
        for i in range(0, max(len(rows), 1), cap):
            part = rows[i:i + cap]
            self.dml.stage(t.table_id, physical_chunk(
                schema, part, max(len(part), 1), self.device))
        return []

    def _dml_target(self, name: str) -> TableDef:
        """The table of a DELETE or UPDATE, with staged DML made visible."""
        t = self.catalog.tables.get(strip_schema(name))
        if t is None:
            raise SqlError(f"table {name!r} not found")
        if t.append_only:
            raise SqlError(f"table {name!r} is APPEND ONLY")
        if len(t.pk) == 1 and t.schema[t.pk[0]].name == "_row_id":
            raise SqlError(
                "DELETE/UPDATE require a declared PRIMARY KEY "
                "(hidden row-id tables are insert-only)")
        if self.dml.has_staged():
            self.tick(generate=False, checkpoint=False)
        self._drain_inflight()
        return t

    def _table_rows(self, t: TableDef) -> list:
        return list(StateTable(self.store, t.table_id, t.schema,
                               list(t.pk)).scan_all())

    def _match_rows(self, t: TableDef, where) -> list:
        """Physical rows of ``t`` that satisfy ``where``."""
        rows = self._table_rows(t)
        if where is None or not rows:
            return rows
        pred = ExprBinder(Scope.of_schema(t.schema)).bind(where)
        cond = pred.eval(physical_chunk(t.schema, rows, len(rows),
                                        self.device))
        keep = (cond.data & cond.mask).tolist()
        return [r for r, k in zip(rows, keep) if k]

    def _delete_dml(self, stmt: A.Delete) -> list:
        t = self._dml_target(stmt.table)
        rows = self._match_rows(t, stmt.where)
        if rows:
            self.dml.stage(t.table_id, make_chunk(
                t.schema, rows, ops=[OP_DELETE] * len(rows),
                capacity=len(rows), device=self.device, physical=True))
        return [("DELETE", len(rows))]

    def _update_dml(self, stmt: A.Update) -> list:
        t = self._dml_target(stmt.table)
        names = list(t.schema.names)
        assigns = []
        for col, e in stmt.assignments:
            if col not in names:
                raise SqlError(f"column {col!r} not found")
            idx = names.index(col)
            b = ExprBinder(Scope.of_schema(t.schema)).bind(e)
            assigns.append((idx, b if b.type == t.schema[idx].type
                            else cast(b, t.schema[idx].type)))
        rows = self._match_rows(t, stmt.where)
        if not rows:
            return [("UPDATE", 0)]
        chunk = physical_chunk(t.schema, rows, len(rows), self.device)
        new_cols = {}
        for idx, e in assigns:
            c = e.eval(chunk)
            new_cols[idx] = (c.data.tolist(), c.mask.tolist())
        new_rows = []
        for r, old in enumerate(rows):
            new = list(old)
            for idx, (d, m) in new_cols.items():
                new[idx] = d[r] if m[r] else None
            new_rows.append(tuple(new))

        def pk_of(row):
            return tuple(row[i] for i in t.pk)

        if not any(idx in t.pk for idx, _ in assigns):
            # same pk: adjacent U-/U+ pairs
            pairs, ops = [], []
            for old, new in zip(rows, new_rows):
                pairs.extend((tuple(old), new))
                ops.extend((OP_UPDATE_DELETE, OP_UPDATE_INSERT))
        else:
            # the pk moves: every delete before every insert, and no
            # update may land on another row's key
            old_pks = {pk_of(r) for r in rows}
            table = StateTable(self.store, t.table_id, t.schema, list(t.pk))
            seen = set()
            for nr in new_rows:
                npk = pk_of(nr)
                if npk in seen:
                    raise SqlError(f"UPDATE produces duplicate key {npk}")
                seen.add(npk)
                if npk not in old_pks and \
                        table.get_row(list(npk)) is not None:
                    raise SqlError(f"UPDATE key {npk} collides with an "
                                   "existing row")
            pairs = [tuple(r) for r in rows] + new_rows
            ops = [OP_DELETE] * len(rows) + [OP_INSERT] * len(new_rows)
        self.dml.stage(t.table_id, make_chunk(
            t.schema, pairs, ops=ops, capacity=len(pairs),
            device=self.device, physical=True))
        return [("UPDATE", len(rows))]

    # ---------------------------------------------------------------- epochs

    def tick(self, generate: bool = True,
             checkpoint: Optional[bool] = None) -> int:
        """One barrier cycle: feed the sources, drain staged DML, inject
        the barrier, and complete the oldest epoch once
        ``in_flight_barriers`` are outstanding (one while a backfill is
        live, so no upstream runs ahead of a snapshot read). Returns the
        last completed epoch."""
        epoch = self._injected + 1
        if checkpoint is None:
            checkpoint = epoch % self.checkpoint_frequency == 0
        mutation, self._pending_mutation = self._pending_mutation, None
        barrier = Barrier.new(epoch, checkpoint=checkpoint,
                              mutation=mutation)
        if generate:
            for feed in self.feeds:
                for _ in range(self.chunks_per_tick):
                    chunk = feed.generator()
                    if chunk is not None:
                        feed.queue.push(chunk)
        for feed in self.feeds:
            if feed.reader is not None:
                feed.offsets_at_epoch[epoch] = feed.reader.offsets
            feed.queue.push(barrier)
        self.inject(barrier)
        self._injected = epoch
        self._inflight.append((epoch, checkpoint))
        live = any(not bf.done for bfs in self.backfills.values()
                   for bf in bfs)
        limit = 1 if live else self.in_flight_barriers
        while len(self._inflight) >= limit:
            self._complete_oldest()
        return self.epoch

    def _complete_oldest(self) -> None:
        self.complete(*self._inflight.pop(0))

    def commit(self, e: int) -> None:
        """The sources' split offsets as of epoch ``e``, then the store."""
        for feed in self.feeds:
            if feed.state_table is None:
                continue
            latest = None
            for oe in sorted(feed.offsets_at_epoch):
                if oe <= e:
                    latest = feed.offsets_at_epoch.pop(oe)
            if latest is not None:
                for sid, off in latest.items():
                    feed.state_table.insert(
                        (VARCHAR.to_physical(sid), int(off)))
                feed.state_table.commit(e)
        super().commit(e)

    def _drain_inflight(self) -> None:
        while self._inflight:
            self._complete_oldest()

    def flush(self) -> None:
        """FLUSH: complete a checkpoint epoch (DML and state committed)."""
        self.tick(generate=False, checkpoint=True)
        self._drain_inflight()

    # ----------------------------------------------------------------- reads

    def query(self, sel: A.Select) -> list:
        """A batch SELECT: lowered to the batch engine over the committed
        state, or through the stream fold where it does not lower."""
        from ..batch.executors import BatchFallback, run_batch
        from ..batch.lower import lower_plan
        self._drain_inflight()
        plan = self._plan(sel)
        try:
            lowered = lower_plan(plan, self.store, catalog=self.catalog,
                                 device=self.device)
            if lowered is not None:
                types = [f.type for f in plan.schema]
                rows = [tuple(None if v is None else types[i].to_python(v)
                              for i, v in enumerate(r))
                        for r in run_batch(lowered)]
                return self._present(rows, sel, plan)
        except BatchFallback:
            pass
        return self._query_stream_fold(sel, plan)

    def _query_stream_fold(self, sel: A.Select, plan) -> list:
        """The plan's stream operators over snapshot sources (two barriers
        around the snapshot), the change stream folded into rows."""
        cap = self.source_chunk_capacity

        def factory(leaf) -> Executor:
            if isinstance(leaf, (PTableScan, PMvScan)):
                d = leaf.table if isinstance(leaf, PTableScan) else leaf.mv
                rows = list(StateTable(self.store, d.table_id, d.schema,
                                       []).scan_all())
                msgs: list[Message] = [Barrier.new(1)]
                for i in range(0, len(rows), cap):
                    part = rows[i:i + cap]
                    msgs.append(physical_chunk(d.schema, part, len(part),
                                               self.device))
                msgs.append(Barrier.new(2))
                return MockSource(d.schema, msgs)
            if isinstance(leaf, PValues):
                return MockSource(leaf.schema, [
                    Barrier.new(1), _values_chunk(leaf, self.device),
                    Barrier.new(2)])
            raise SqlError(
                "batch SELECT over an unbounded source is not supported; "
                "create a materialized view instead")

        ctx = BuildContext(self.store, self.catalog.next_table_id, factory,
                           self.config, durable=False, device=self.device)
        pipeline = build_plan(plan, ctx)

        async def run() -> list:
            rows = []
            async for msg in pipeline.execute():
                if isinstance(msg, StreamChunk):
                    rows.extend(chunk_to_rows(msg, pipeline.schema,
                                              with_ops=True))
            return rows

        acc: dict = {}
        for op, row in self._await(run()):
            n = acc.get(row, 0) + (1 if op in (OP_INSERT, OP_UPDATE_INSERT)
                                   else -1)
            if n:
                acc[row] = n
            else:
                acc.pop(row, None)
        out = [row for row, n in acc.items() for _ in range(n)]
        return self._present(out, sel, plan)

    def _present(self, rows: list, sel: A.Select, plan) -> list:
        """ORDER BY on the host, then the hidden columns dropped."""
        schema = plan.schema
        if sel.order_by:
            scope = Scope.of_schema(schema)
            keys = []
            for oi in sel.order_by:
                b = ExprBinder(scope).bind(oi.expr)
                if isinstance(b, InputRef):
                    keys.append((b.index, oi.desc))
            for idx, desc in reversed(keys):
                rows = sorted(rows, key=lambda r: (
                    r[idx] is None, r[idx] if r[idx] is not None else 0),
                    reverse=desc)
        visible = [i for i, f in enumerate(schema)
                   if not f.name.startswith("_")]
        if len(visible) != len(schema):
            rows = [tuple(r[i] for i in visible) for r in rows]
        return rows

    def mv_rows(self, name: str) -> list:
        """An MV's rows (visible columns, decoded)."""
        self._drain_inflight()
        mv = self.catalog.mvs.get(name)
        if mv is None:
            raise SqlError(f"materialized view {name!r} not found")
        n_vis = mv.n_visible
        return [tuple(None if v is None else mv.schema[i].type.to_python(v)
                      for i, v in enumerate(phys[:n_vis]))
                for phys in self.jobs[name].table.scan_all()]

    def close(self) -> None:
        if self.loop.is_closed():
            return
        self._drain_inflight()
        super().close()
