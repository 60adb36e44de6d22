"""Plan tree → wired executor pipeline.

Counterpart of ``risingwave_tpu/frontend/build.py``: ``build_plan`` turns
each plan node into the port's stream executor, recursively, every
executor on ``ctx.device``, and allocates the state table of every stateful
operator in build order (the reference's order, so one package's store
snapshot reads in the other's tables). A grouped agg or an equi-join with
``fragment_parallelism > 1`` builds as a ``FragmentGraph``
(``frontend/fragments.py``). The mesh-sharded executors are ROADMAP A5.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .. import DEFAULT_DEVICE
from ..common.types import Field, INT64, Schema
from ..ops.join_state import JoinType
from ..storage.state_store import MemoryStateStore
from ..storage.state_table import StateTable
from ..stream.dynamic_filter import DynamicFilterExecutor
from ..stream.eowc import SortExecutor
from ..stream.executor import (
    EpochCheckExecutor, Executor, SchemaCheckExecutor, UpdateCheckExecutor,
)
from ..stream.hash_agg import HashAggExecutor, agg_state_schema
from ..stream.hash_join import HashJoinExecutor
from ..stream.hop_window import HopWindowExecutor
from ..stream.materialized_agg import (
    MaterializedAggExecutor, call_needs_materialized,
    materialized_agg_state_schema,
)
from ..stream.over_window import (
    EowcOverWindowExecutor, OverWindowExecutor, eowc_acc_schema,
)
from ..stream.project import FilterExecutor, ProjectExecutor
from ..stream.project_set import ProjectSetExecutor
from ..stream.simple_agg import SimpleAggExecutor, simple_agg_state_schema
from ..stream.temporal_join import TemporalJoinExecutor
from ..stream.top_n import TopNExecutor
from ..stream.union import UnionExecutor
from . import planner as P
from .fragments import build_fragmented_agg, build_fragmented_join

_JOIN_TYPES = {
    "inner": JoinType.INNER, "left": JoinType.LEFT_OUTER,
    "right": JoinType.RIGHT_OUTER, "full": JoinType.FULL_OUTER,
    "left_semi": JoinType.LEFT_SEMI, "left_anti": JoinType.LEFT_ANTI,
}

_LEAVES = (P.PSource, P.PTableScan, P.PMvScan, P.PValues)


@dataclasses.dataclass
class BuildConfig:
    chunk_capacity: int = 1024
    agg_table_capacity: int = 1 << 16
    join_key_capacity: int = 1 << 13
    join_bucket_width: int = 16
    topn_table_capacity: int = 1 << 16
    # the reference's device mesh for sharded aggs and joins; only None
    # builds here (ROADMAP A5)
    mesh: Optional[object] = None
    # >1 builds grouped aggs and equi-joins as multi-fragment jobs: the
    # upstream hash-dispatches to N actors whose outputs merge
    fragment_parallelism: int = 1
    exchange_permits: int = 32
    # the reference's co-scheduled and tick-compiled MV paths (ROADMAP A4):
    # a Session refuses a CREATE MATERIALIZED VIEW with either set
    coschedule: bool = False
    tick_compiler: bool = False
    # cap on live groups per grouped agg (coldest evict to the state
    # table at checkpoints); None = grow or raise
    agg_hbm_budget: Optional[int] = None
    # cap on live join keys per arena; None = grow or raise
    join_hbm_budget: Optional[int] = None
    # snapshot rows per barrier of a Backfill; None = max(4 chunks, 4096)
    backfill_batch_rows: Optional[int] = None
    # wrap every built executor in the schema, epoch and update-pair checks
    sanity_checks: bool = False


def join_state_pk(join_keys, stream_pk) -> list:
    """A join side's state-table pk: the join keys, then the side's stream
    pk (rows of one key are contiguous in key order)."""
    return list(join_keys) + [i for i in stream_pk if i not in join_keys]


class BuildContext:
    """Per-job build state: the leaves' factory and the state tables.

    ``source_factory(plan_node) -> Executor`` supplies the leaves: queue-fed
    sources for a streaming job, snapshot replays for a batch query.
    ``durable=False`` allocates no state table."""

    def __init__(
        self,
        store: MemoryStateStore,
        next_table_id: Callable[[], int],
        source_factory: Callable[[P.PlanNode], Executor],
        config: Optional[BuildConfig] = None,
        durable: bool = True,
        device=DEFAULT_DEVICE,
    ):
        self.store = store
        self.next_table_id = next_table_id
        self.source_factory = source_factory
        self.config = config or BuildConfig()
        self.durable = durable
        self.device = device
        self.state_table_ids: list[int] = []

    def state_table(self, schema: Schema, pk) -> Optional[StateTable]:
        if not self.durable:
            return None
        tid = self.next_table_id()
        self.state_table_ids.append(tid)
        return StateTable(self.store, tid, schema, list(pk))


def build_plan(plan: P.PlanNode, ctx: BuildContext) -> Executor:
    """Build one plan node (recursively); with ``sanity_checks`` every
    built executor is wrapped in the schema, update-pair and epoch checks."""
    ex = _build_plan(plan, ctx)
    if ctx.config.sanity_checks:
        ex = SchemaCheckExecutor(UpdateCheckExecutor(EpochCheckExecutor(ex)))
    return ex


def _fragmented(plan_keys, ctx: BuildContext) -> bool:
    return bool(plan_keys) and ctx.config.fragment_parallelism > 1 \
        and ctx.durable


def _build_agg(plan: P.PAgg, ctx: BuildContext) -> Executor:
    cfg, dev = ctx.config, ctx.device
    if any(call_needs_materialized(c, plan.append_only_input)
           for c in plan.agg_calls):
        # DISTINCT, array_agg, string_agg, percentiles, mode and MIN/MAX
        # under retraction keep their inputs on the host tier; every
        # sibling call rides along
        if plan.eowc:
            raise ValueError(
                "EMIT ON WINDOW CLOSE does not support materialized-"
                "input aggregates")
        inp = build_plan(plan.input, ctx)
        key_fields = [plan.input.schema[i] for i in plan.group_keys]
        st = ctx.state_table(materialized_agg_state_schema(key_fields),
                             list(range(len(plan.group_keys) + 5)))
        return MaterializedAggExecutor(
            inp, list(plan.group_keys), list(plan.agg_calls),
            state_table=st, out_capacity=cfg.chunk_capacity, device=dev)
    inp = build_plan(plan.input, ctx)
    if not plan.group_keys:
        st = ctx.state_table(simple_agg_state_schema(plan.agg_calls), [0])
        return SimpleAggExecutor(inp, list(plan.agg_calls), state_table=st,
                                 device=dev)
    key_fields = [plan.input.schema[i] for i in plan.group_keys]
    st = ctx.state_table(agg_state_schema(key_fields, plan.agg_calls),
                         list(range(len(plan.group_keys))))
    common = dict(state_table=st, table_capacity=cfg.agg_table_capacity,
                  out_capacity=cfg.chunk_capacity,
                  hbm_group_budget=cfg.agg_hbm_budget, device=dev)
    if _fragmented(plan.group_keys, ctx):
        return build_fragmented_agg(
            inp, list(plan.group_keys), list(plan.agg_calls),
            parallelism=cfg.fragment_parallelism,
            exchange_permits=cfg.exchange_permits, **common)
    return HashAggExecutor(inp, list(plan.group_keys), list(plan.agg_calls),
                           **common)


def _build_join(plan: P.PJoin, ctx: BuildContext) -> Executor:
    cfg = ctx.config
    fragmented = _fragmented(plan.left_keys, ctx)
    if getattr(plan, "null_aware", False) and fragmented:
        # a fragmented anti join does not carry the NOT IN null guard
        raise ValueError(
            "NOT IN (SELECT ...) is not supported on fragmented join "
            "layouts; use NOT EXISTS or the default layout")
    left = build_plan(plan.left, ctx)
    right = build_plan(plan.right, ctx)
    lst = ctx.state_table(plan.left.schema,
                          join_state_pk(plan.left_keys, plan.left.pk))
    rst = ctx.state_table(plan.right.schema,
                          join_state_pk(plan.right_keys, plan.right.pk))
    common = dict(join_type=_JOIN_TYPES[plan.kind], condition=plan.condition,
                  left_state_table=lst, right_state_table=rst,
                  key_capacity=cfg.join_key_capacity,
                  bucket_width=cfg.join_bucket_width,
                  out_capacity=cfg.chunk_capacity,
                  hbm_key_budget=cfg.join_hbm_budget, device=ctx.device)
    if fragmented:
        return build_fragmented_join(
            left, right, list(plan.left_keys), list(plan.right_keys),
            parallelism=cfg.fragment_parallelism,
            exchange_permits=cfg.exchange_permits, **common)
    return HashJoinExecutor(
        left, right, list(plan.left_keys), list(plan.right_keys),
        null_aware_anti=getattr(plan, "null_aware", False), **common)


def _build_over_window(plan: P.POverWindow, ctx: BuildContext) -> Executor:
    cfg, dev = ctx.config, ctx.device
    inp = build_plan(plan.input, ctx)
    in_schema = plan.input.schema
    pk = list(plan.input.pk)
    if not plan.eowc:
        st = ctx.state_table(in_schema, pk)
        return OverWindowExecutor(inp, plan.calls, pk_indices=pk,
                                  state_table=st,
                                  out_capacity=cfg.chunk_capacity,
                                  device=dev)
    order_col = plan.calls[0].order_by[0].col
    sort_st = ctx.state_table(in_schema, pk)
    inp = SortExecutor(inp, time_col=order_col, pk_indices=pk,
                       state_table=sort_st,
                       table_capacity=cfg.topn_table_capacity,
                       out_capacity=cfg.chunk_capacity, device=dev)
    acc_schema = eowc_acc_schema(in_schema, plan.calls)
    npart = len(plan.calls[0].partition_by)
    acc_st = ctx.state_table(acc_schema, list(range(npart)))
    buf_st = ctx.state_table(in_schema, pk)
    return EowcOverWindowExecutor(
        inp, plan.calls, pk_indices=pk, acc_table=acc_st,
        buffer_table=buf_st, out_capacity=cfg.chunk_capacity, device=dev)


def _build_plan(plan: P.PlanNode, ctx: BuildContext) -> Executor:
    cfg, dev = ctx.config, ctx.device
    if cfg.mesh is not None:
        raise NotImplementedError(
            "mesh-sharded executors are ROADMAP A5 (multi-GPU)")
    if isinstance(plan, _LEAVES):
        return ctx.source_factory(plan)
    if isinstance(plan, P.PProject):
        return ProjectExecutor(build_plan(plan.input, ctx), list(plan.exprs),
                               names=plan.schema.names)
    if isinstance(plan, P.PFilter):
        return FilterExecutor(build_plan(plan.input, ctx), plan.predicate)
    if isinstance(plan, P.PHopWindow):
        return HopWindowExecutor(build_plan(plan.input, ctx), plan.time_col,
                                 plan.slide, plan.size)
    if isinstance(plan, P.PAgg):
        return _build_agg(plan, ctx)
    if isinstance(plan, P.PJoin):
        return _build_join(plan, ctx)
    if isinstance(plan, P.PTopN):
        inp = build_plan(plan.input, ctx)
        st = ctx.state_table(plan.schema, list(plan.pk))
        return TopNExecutor(
            inp, list(plan.order), plan.offset, plan.limit,
            pk_indices=list(plan.pk), group_by=list(plan.group_by),
            with_ties=plan.with_ties, state_table=st,
            table_capacity=cfg.topn_table_capacity,
            out_capacity=cfg.chunk_capacity, device=dev)
    if isinstance(plan, P.PDynFilter):
        left = build_plan(plan.input, ctx)
        right = build_plan(plan.right, ctx)
        st = ctx.state_table(plan.schema, list(plan.pk))
        bt = None
        if st is not None:
            bt = ctx.state_table(
                Schema((Field("id", INT64),
                        Field("bound", plan.schema[plan.key_col].type))), [0])
        return DynamicFilterExecutor(
            left, right, key_col=plan.key_col, cmp=plan.cmp,
            pk_indices=list(plan.pk), state_table=st, bound_table=bt,
            table_capacity=cfg.topn_table_capacity,
            out_capacity=cfg.chunk_capacity, device=dev)
    if isinstance(plan, P.PTemporalJoin):
        rdef = plan.right_def
        right_table = StateTable(ctx.store, rdef.table_id, rdef.schema,
                                 list(rdef.pk))
        return TemporalJoinExecutor(
            build_plan(plan.input, ctx), right_table, list(plan.left_keys),
            list(plan.right_keys), outer=plan.outer,
            condition=plan.condition, out_capacity=cfg.chunk_capacity,
            device=dev)
    if isinstance(plan, P.POverWindow):
        return _build_over_window(plan, ctx)
    if isinstance(plan, P.PProjectSet):
        return ProjectSetExecutor(build_plan(plan.input, ctx),
                                  list(plan.exprs), names=plan.schema.names,
                                  out_capacity=cfg.chunk_capacity,
                                  device=dev)
    if isinstance(plan, P.PUnion):
        return UnionExecutor([build_plan(i, ctx) for i in plan.inputs])
    raise NotImplementedError(f"cannot build {type(plan).__name__}")


def collect_leaves(plan: P.PlanNode) -> list:
    """All leaf nodes (sources, scans, values) in plan order."""
    if not plan.children:
        return [plan] if isinstance(plan, _LEAVES) else []
    out = []
    for c in plan.children:
        out.extend(collect_leaves(c))
    return out
