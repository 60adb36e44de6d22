"""Plan lowering: stream plan tree → batch executor chain.

Counterpart of ``risingwave_tpu/batch/lower.py``'s ``lower_plan`` and
``_index_scan``. ``lower_plan`` returns None for shapes only the streaming
engine runs (EOWC, DISTINCT aggs, WITH TIES or grouped TopN, window
functions, HOP, ProjectSet, unions, dynamic filters): those SELECTs take
the Session's stream fold. A join the batch join cannot serve raises
``BatchFallback`` at run time, and the Session falls back the same way.
The two-phase split of the serving plane is ROADMAP A6 part 2.
"""

from __future__ import annotations

from typing import Optional

from .. import DEFAULT_DEVICE
from ..expr.expr import FunctionCall, InputRef, Literal
from ..frontend import planner as P
from ..frontend.optimizer import conjuncts_of
from ..storage.state_table import StateTable
from .executors import (
    BatchExecutor, BatchFilter, BatchHashAgg, BatchHashJoin, BatchLimit,
    BatchProject, BatchSort, RowSeqScan,
)


def _index_scan(plan: P.PFilter, catalog, store,
                device) -> Optional[BatchExecutor]:
    """Filter over a scan with constant equality on an index's leading
    columns → prefix scan of the index's arrangement MV, permuted into the
    filter's input order, with the whole predicate applied again."""
    base = plan.input
    # column pruning may put a projection of InputRefs over the scan
    mapping = None
    if (isinstance(base, P.PProject)
            and all(isinstance(e, InputRef) for e in base.exprs)
            and isinstance(base.input, (P.PTableScan, P.PMvScan))):
        mapping = [e.index for e in base.exprs]
        base = base.input
    if not isinstance(base, (P.PTableScan, P.PMvScan)):
        return None
    d = base.table if isinstance(base, P.PTableScan) else base.mv
    if getattr(d, "n_visible", len(d.schema)) != len(d.schema):
        return None                       # hidden columns: mapping unsafe
    if mapping is None:
        mapping = list(range(len(d.schema)))
    eq: dict = {}                         # base column -> literal
    for c in conjuncts_of(plan.predicate):
        if (isinstance(c, FunctionCall) and c.name == "equal"
                and len(c.args) == 2):
            a, b = c.args
            if isinstance(a, Literal) and isinstance(b, InputRef):
                a, b = b, a
            if (isinstance(a, InputRef) and isinstance(b, Literal)
                    and b.value is not None):
                eq.setdefault(mapping[a.index], b)
    if not eq:
        return None
    col_names = [f.name for f in d.schema]
    best = None
    for ix in catalog.indexes.values():
        if ix.table != getattr(d, "name", None) or not ix.mv_name:
            continue
        mv = catalog.mvs.get(ix.mv_name)
        if mv is None:
            continue
        vals = []
        for cname in ix.columns:
            pos = col_names.index(cname)
            if pos not in eq:
                break
            vals.append(eq[pos])
        if vals and (best is None or len(vals) > len(best[1])):
            best = (mv, vals)
    if best is None:
        return None
    mv, lits = best
    scan = RowSeqScan(StateTable(store, mv.table_id, mv.schema, list(mv.pk)),
                      prefix=[lit.type.to_physical(lit.value)
                              for lit in lits], device=device)
    mv_names = [f.name for f in mv.schema]
    exprs = [InputRef(mv_names.index(col_names[bi]), d.schema[bi].type)
             for bi in mapping]
    proj = BatchProject(scan, exprs, names=[col_names[bi] for bi in mapping])
    return BatchFilter(proj, plan.predicate)


def lower_plan(plan: P.PlanNode, store, catalog=None,
               device=DEFAULT_DEVICE) -> Optional[BatchExecutor]:
    """The batch executor chain of ``plan``, or None for a shape only the
    stream fold runs."""
    def lower(node):
        return lower_plan(node, store, catalog, device)

    if isinstance(plan, (P.PTableScan, P.PMvScan)):
        d = plan.table if isinstance(plan, P.PTableScan) else plan.mv
        return RowSeqScan(StateTable(store, d.table_id, d.schema,
                                     list(d.pk)), device=device)
    if isinstance(plan, P.PProject):
        inp = lower(plan.input)
        return None if inp is None else BatchProject(
            inp, list(plan.exprs), names=plan.schema.names)
    if isinstance(plan, P.PFilter):
        if catalog is not None:
            ix = _index_scan(plan, catalog, store, device)
            if ix is not None:
                return ix
        inp = lower(plan.input)
        return None if inp is None else BatchFilter(inp, plan.predicate)
    if isinstance(plan, P.PAgg):
        if plan.eowc or any(c.distinct for c in plan.agg_calls):
            return None
        inp = lower(plan.input)
        return None if inp is None else BatchHashAgg(
            inp, list(plan.group_keys), list(plan.agg_calls), device=device)
    if isinstance(plan, P.PJoin):
        if plan.kind not in ("inner", "left", "right", "full",
                             "left_semi", "left_anti"):
            return None
        left, right = lower(plan.left), lower(plan.right)
        if left is None or right is None:
            return None
        # build the left side of an inner join when only its pk is covered
        # by the join keys (no trial build of a side with duplicates)
        r_unique = bool(plan.right.pk) and \
            set(plan.right.pk) <= set(plan.right_keys)
        l_unique = bool(plan.left.pk) and \
            set(plan.left.pk) <= set(plan.left_keys)
        prefer = ("left" if (plan.kind == "inner"
                             and not r_unique and l_unique) else "right")
        return BatchHashJoin(left, right, list(plan.left_keys),
                             list(plan.right_keys), join_type=plan.kind,
                             condition=plan.condition, prefer_build=prefer,
                             null_aware=getattr(plan, "null_aware", False),
                             device=device)
    if isinstance(plan, P.PTopN):
        if plan.with_ties or plan.group_by:
            return None
        inp = lower(plan.input)
        return None if inp is None else BatchLimit(
            BatchSort(inp, list(plan.order)), limit=plan.limit,
            offset=plan.offset)
    return None
