"""Copy of ``risingwave_tpu/frontend/planner.py``: the reference's text, its
relative imports resolving to the port's modules. Two changes: the system
relations (``system_catalog.py``, ROADMAP A6 part 2) raise ``PlanError``; a
window's end is ``call("add", ...)`` (the port's ``Expr`` has no operator
sugar).

Planner: bound SELECT → stream plan tree (with stream-key derivation).

Counterpart of the reference's Planner + stream-side optimizer phases
(reference: src/frontend/src/planner/mod.rs:37,53 and
optimizer/plan_node/stream_*.rs). Each plan node carries its ``pk`` — the
stream key that identifies rows across updates (the reference's logical_pk):
Source appends a hidden ``_row_id``; Agg's pk is its group keys; Join's is
the concatenation of both sides' pks; Project keeps pk columns alive by
appending hidden columns when the SELECT list drops them (exactly the
reference's add-logical-pk rule).

Scalar-subquery comparisons in WHERE lower to DynamicFilter; ORDER BY +
LIMIT lowers to TopN; DISTINCT lowers to group-by-all-columns Agg
(reference: the corresponding optimizer rules under
src/frontend/src/optimizer/rule/).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

from ..common.types import Field, Schema, TIMESTAMP
from ..expr.agg import AggCall
from ..expr.expr import Expr, FunctionCall, InputRef, Literal, call
from ..ops.topn import OrderSpec
from . import sqlast as A
from .binder import (
    AGG_KINDS, WINDOW_ONLY_KINDS, BindError, BoundAgg, BoundWindow,
    ExprBinder, Scope, ScopeColumn, _AggPlaceholder, _SubqueryPlaceholder,
    _WindowPlaceholder, contains_placeholder, rewrite_placeholders,
)
from .catalog import Catalog, CatalogError, MaterializedViewDef, SourceDef, TableDef


class PlanError(ValueError):
    pass


# -- plan nodes ---------------------------------------------------------------


@dataclasses.dataclass
class PlanNode:
    schema: Schema
    pk: tuple                        # stream-key column indices

    @property
    def children(self) -> tuple:
        return ()

    def label(self) -> str:
        return type(self).__name__[1:]

    def explain(self, indent: int = 0) -> str:
        lines = [" " * indent + self._describe()]
        for c in self.children:
            lines.append(c.explain(indent + 2))
        return "\n".join(lines)

    def _describe(self) -> str:
        return f"{self.label()} {{pk={list(self.pk)}}}"


@dataclasses.dataclass
class PSource(PlanNode):
    source: SourceDef
    row_id_index: int = -1           # hidden _row_id column index


@dataclasses.dataclass
class PTableScan(PlanNode):
    table: TableDef


@dataclasses.dataclass
class PMvScan(PlanNode):
    mv: MaterializedViewDef


@dataclasses.dataclass
class PExchange(PlanNode):
    """Leaf standing in for a remote-exchange edge inside a SHIPPED
    fragment subtree: the fragment below this point runs in a different
    fragment (possibly on a different worker process), and its output
    arrives here over permit-metered exchange channels (reference: the
    ExchangeNode leaves the fragmenter leaves behind,
    src/frontend/src/stream_fragmenter/mod.rs:115). ``upstream`` names
    the feeding fragment id in the job's span graph; the worker's build
    factory resolves it to a merge over the edge's channels."""

    upstream: int = -1

    def _describe(self):
        return f"Exchange {{upstream=f{self.upstream}, pk={list(self.pk)}}}"


@dataclasses.dataclass
class PRemoteFragment(PlanNode):
    """A batch stage shipped to the worker PROCESS hosting its state; the
    session sees only the stage's output rows (reference: distributed
    batch stages over compute nodes,
    src/frontend/src/scheduler/distributed/query.rs:69,115).
    ``fetch()`` runs the remote task and returns physical rows."""

    job: str = ""
    fetch: Any = None                # () -> list[physical row tuples]

    @property
    def children(self):
        return ()

    def _describe(self):
        return f"RemoteFragment {{job={self.job}}}"


@dataclasses.dataclass
class PProject(PlanNode):
    input: PlanNode
    exprs: tuple                     # runtime Expr per output column

    @property
    def children(self):
        return (self.input,)

    def _describe(self):
        return (f"Project {{exprs={[_expr_str(e) for e in self.exprs]}, "
                f"pk={list(self.pk)}}}")


@dataclasses.dataclass
class PFilter(PlanNode):
    input: PlanNode
    predicate: Expr

    @property
    def children(self):
        return (self.input,)

    def _describe(self):
        return f"Filter {{pred={_expr_str(self.predicate)}, pk={list(self.pk)}}}"


@dataclasses.dataclass
class PHopWindow(PlanNode):
    input: PlanNode
    time_col: int
    slide: int
    size: int

    @property
    def children(self):
        return (self.input,)


@dataclasses.dataclass
class PAgg(PlanNode):
    input: PlanNode
    group_keys: tuple                # input column indices
    agg_calls: tuple                 # AggCall...
    append_only_input: bool = False
    eowc: bool = False
    #: batch two-phase aggregation (batch/lower.py split_two_phase):
    #: "single" = ordinary one-shot agg; "partial" = emit raw per-group
    #: state lanes instead of projected outputs — the distributed serving
    #: plane ships partial-phase subtrees to the workers owning the vnode
    #: slices and merges the lanes in the session (reference: the
    #: two-phase agg split in src/frontend/src/scheduler/distributed/
    #: query.rs:69-115). ``schema`` of a partial node is the lane
    #: transport schema, not the user-facing agg schema.
    phase: str = "single"

    @property
    def children(self):
        return (self.input,)

    def _describe(self):
        calls = [f"{c.kind}({c.arg if c.arg >= 0 else '*'})"
                 for c in self.agg_calls]
        ph = "" if self.phase == "single" else f", phase={self.phase}"
        return (f"{'SimpleAgg' if not self.group_keys else 'HashAgg'} "
                f"{{keys={list(self.group_keys)}, aggs={calls}, "
                f"pk={list(self.pk)}{ph}}}")


@dataclasses.dataclass
class PJoin(PlanNode):
    left: PlanNode
    right: PlanNode
    kind: str                        # inner/left/right/full/left_semi/left_anti
    left_keys: tuple
    right_keys: tuple
    condition: Optional[Expr]        # residual non-equi condition, over concat
    #: PG NOT IN semantics for a left_anti join: a NULL in the subquery
    #: (build side) means NO probe row passes. The planner also filters
    #: NULL probe keys below the join (they never pass NOT IN).
    null_aware: bool = False

    @property
    def children(self):
        return (self.left, self.right)

    def _describe(self):
        na = ", null_aware" if self.null_aware else ""
        return (f"HashJoin {{type={self.kind}, on={list(self.left_keys)}="
                f"{list(self.right_keys)}{na}, pk={list(self.pk)}}}")


@dataclasses.dataclass
class PTopN(PlanNode):
    input: PlanNode
    order: tuple                     # OrderSpec...
    limit: int
    offset: int
    with_ties: bool = False
    group_by: tuple = ()

    @property
    def children(self):
        return (self.input,)

    def _describe(self):
        return (f"TopN {{order={[(o.col, 'desc' if o.desc else 'asc') for o in self.order]}, "
                f"limit={self.limit}, offset={self.offset}, pk={list(self.pk)}}}")


@dataclasses.dataclass
class PDynFilter(PlanNode):
    input: PlanNode
    right: PlanNode                  # 1-row plan producing the bound
    key_col: int
    cmp: str

    @property
    def children(self):
        return (self.input, self.right)

    def _describe(self):
        return f"DynamicFilter {{col={self.key_col} {self.cmp} <sub>, pk={list(self.pk)}}}"


@dataclasses.dataclass
class PUnion(PlanNode):
    inputs: tuple

    @property
    def children(self):
        return tuple(self.inputs)


@dataclasses.dataclass
class PValues(PlanNode):
    rows: tuple


@dataclasses.dataclass
class POverWindow(PlanNode):
    """Window functions over a shared (partition, order) frame; output =
    input columns ⧺ one column per call (reference: StreamOverWindow plan
    node, optimizer/plan_node/stream_over_window.rs)."""

    input: PlanNode
    calls: tuple                     # stream.over_window.WindowCall...
    eowc: bool = False

    @property
    def children(self):
        return (self.input,)


@dataclasses.dataclass
class PTemporalJoin(PlanNode):
    """Process-time lookup join (reference: temporal_join.rs:352): the
    stream side probes the right relation's CURRENT materialized rows; no
    stream-side state, no retraction on table changes."""

    input: PlanNode                  # the stream side
    right_kind: str                  # "table" | "mv"
    right_def: object                # TableDef | MaterializedViewDef
    left_keys: tuple
    right_keys: tuple
    outer: bool = False
    condition: object = None

    @property
    def children(self):
        return (self.input,)


@dataclasses.dataclass
class PProjectSet(PlanNode):
    """Set-returning projection: each input row yields one output row per
    element of the table function's result (reference: ProjectSetExecutor,
    src/stream/src/executor/project_set.rs). ``exprs`` are per-output-col;
    exactly one is a _TableFuncExpr. Output pk = input pk ⧺ hidden index."""

    input: PlanNode
    exprs: tuple

    @property
    def children(self):
        return (self.input,)


def _expr_str(e: Expr) -> str:
    if isinstance(e, InputRef):
        return f"${e.index}"
    if isinstance(e, Literal):
        return repr(e.value)
    if isinstance(e, FunctionCall):
        return f"{e.name}({', '.join(_expr_str(a) for a in e.args)})"
    return type(e).__name__


# -- helpers ------------------------------------------------------------------


def _conjuncts(e: A.Expr) -> list:
    if isinstance(e, A.BinaryOp) and e.op == "AND":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


#: the reference's system relations (``system_catalog.py``), which resolve
#: before user relations of the same name
_SYSTEM_RELATIONS = {
    "information_schema.columns", "information_schema.tables",
    "pg_catalog.pg_matviews", "pg_catalog.pg_tables", "pg_matviews",
    "pg_tables", "rw_catalog.rw_relations", "rw_relations",
} | {p + n for p in ("", "rw_catalog.") for n in (
    "rw_actors", "rw_autoscaler_decisions", "rw_barrier_history",
    "rw_barrier_inflight", "rw_dispatch_profiles", "rw_fragments",
    "rw_hbm_ledger", "rw_leader_history", "rw_placements",
    "rw_worker_nodes")}

_CMP_TO_FN = {
    ">": "greater_than", ">=": "greater_than_or_equal",
    "<": "less_than", "<=": "less_than_or_equal",
}
_CMP_FLIP = {">": "<", ">=": "<=", "<": ">", "<=": ">="}


class Planner:
    """Plans one SELECT against the catalog. ``fresh`` — hidden-column name
    uniquifier shared across nested planners."""

    def __init__(self, catalog: Catalog, lenient: bool = False,
                 session=None):
        # lenient = DDL replay during recovery: rules tightened after a
        # statement was logged must WARN, not make the store unloadable
        self.catalog = catalog
        self.lenient = lenient
        # live Session backing the rw_catalog telemetry relations; None
        # in session-less contexts (describe, DDL replay), where they
        # would return their schema with no rows
        self.session = session

    # -- entry ----------------------------------------------------------------

    def plan_select(self, sel: A.Select) -> PlanNode:
        if sel.union_all is not None:
            left = self.plan_select(dataclasses.replace(sel, union_all=None))
            right = self.plan_select(sel.union_all)
            if len(left.schema) != len(right.schema):
                raise PlanError("UNION ALL arms must have equal arity")
            # align pk layout: use full row as key via dedicated hidden cols
            # (reference unions carry a source-id in the stream key)
            return PUnion(schema=left.schema, pk=tuple(range(len(left.schema))),
                          inputs=(left, right))

        if sel.from_ is None:
            return self._plan_no_from(sel)

        # WHERE: split conjuncts into dynamic-filter rewrites and plain ones;
        # plain equality conjuncts may be consumed as join keys by keyless
        # (comma-syntax) joins during relation planning — the reference's
        # predicate-pushdown-into-join rule
        dyn_conjuncts: list = []
        in_conjuncts: list = []
        plain: list = []
        if sel.where is not None:
            for conj in _conjuncts(sel.where):
                if isinstance(conj, A.InSubquery):
                    in_conjuncts.append(conj)
                elif self._has_subquery(conj):
                    dyn_conjuncts.append(conj)
                else:
                    plain.append(conj)

        node, scope = self._plan_relation(sel.from_, plain)

        for conj in plain:
            pred = ExprBinder(scope).bind(conj)
            node = PFilter(schema=node.schema, pk=node.pk, input=node,
                           predicate=pred)

        # IN (SELECT …) conjuncts become left semi joins; NOT IN becomes
        # a NULL-AWARE left anti join (reference: subquery unnesting Apply
        # rules, src/frontend/src/optimizer/rule/apply_join_transpose_rule.rs):
        # NULL probe keys are filtered below the join, and a NULL produced
        # by the subquery yields no rows (batch) / a loud error (streaming).
        for conj in in_conjuncts:
            node = self._plan_in_subquery(conj, node, scope)

        # dynamic filters apply pre-projection (reference: the subquery
        # Apply-rewrite places DynamicFilter below the projection)
        for conj in dyn_conjuncts:
            node = self._plan_dynamic_filter(conj, node, scope)

        has_aggs = bool(sel.group_by) or self._select_has_aggs(sel)
        has_windows = self._select_has_windows(sel)
        if self._select_has_table_funcs(sel):
            if has_aggs or has_windows:
                raise PlanError("set-returning functions cannot mix with "
                                "aggregates/window functions; use a subquery")
            node, scope = self._plan_project_set(sel, node, scope)
        elif has_windows:
            if has_aggs:
                raise PlanError(
                    "window functions cannot mix with GROUP BY/aggregates "
                    "in one SELECT; use a subquery")
            node, scope = self._plan_over_window(sel, node, scope)
        elif has_aggs:
            node, scope = self._plan_agg(sel, node, scope)
        else:
            node, scope = self._plan_projection(sel, node, scope)

        if sel.having is not None and not has_aggs:
            raise PlanError("HAVING without aggregation")

        if sel.distinct:
            # dedup over the VISIBLE columns; hidden stream-key columns are
            # dropped (the distinct keys become the new stream key)
            visible = tuple(i for i, f in enumerate(node.schema)
                            if not f.name.startswith("_"))
            if len(visible) != len(node.schema):
                node = PProject(
                    schema=node.schema.select(visible), pk=(), input=node,
                    exprs=tuple(InputRef(i, node.schema[i].type)
                                for i in visible))
            n = len(node.schema)
            node = PAgg(
                schema=Schema(tuple(node.schema)), pk=tuple(range(n)),
                input=node, group_keys=tuple(range(n)), agg_calls=())

        if sel.order_by or sel.limit is not None:
            node = self._plan_topn(sel, node, scope)
        return node

    # -- FROM -----------------------------------------------------------------

    def _plan_relation(self, rel: A.Relation, pending_conjuncts=None):
        if isinstance(rel, A.TableRef):
            return self._plan_table_ref(rel)
        if isinstance(rel, A.TableFuncRef):
            return self._plan_table_func_ref(rel)
        if isinstance(rel, A.WindowTVF):
            return self._plan_window_tvf(rel)
        if isinstance(rel, A.SubqueryRef):
            node = self.plan_select(rel.query)
            return node, Scope.of_schema(node.schema, rel.alias)
        if isinstance(rel, A.Join):
            return self._plan_join(rel, pending_conjuncts)
        raise PlanError(f"unsupported relation {type(rel).__name__}")

    def _plan_table_ref(self, ref: A.TableRef):
        # system catalogs (pg_catalog / information_schema / rw_catalog)
        # come with the serving plane's system views (ROADMAP A6 part 2)
        if ref.name.lower() in _SYSTEM_RELATIONS:
            raise PlanError(
                f"system relation {ref.name!r} is not available yet "
                "(ROADMAP A6 part 2: frontend/system_catalog.py)")
        # BI tools qualify user relations with the schema pg_tables
        # reports ('public.t'): the catalog is keyed on bare names
        name = ref.name
        if name.startswith("public."):
            name = name[len("public."):]
        kind, d = self.catalog.resolve_relation(name)
        alias = ref.alias or name
        if kind == "source":
            # hidden _row_id appended: the stream key of a keyless source
            # (reference: row_id_gen.rs + logical source planning)
            from ..common.types import SERIAL
            schema = Schema(tuple(d.schema) + (Field("_row_id", SERIAL),))
            n = len(schema)
            node = PSource(schema=schema, pk=(n - 1,), source=d,
                           row_id_index=n - 1)
            scope = Scope([
                ScopeColumn(f.name, alias, i, f.type)
                for i, f in enumerate(d.schema)
            ])
            return node, scope
        if kind == "table":
            node = PTableScan(schema=d.schema, pk=tuple(d.pk), table=d)
            return node, Scope.of_schema(d.schema, alias)
        node = PMvScan(schema=d.schema, pk=tuple(d.pk), mv=d)
        n_vis = getattr(d, "n_visible", len(d.schema))
        scope = Scope([
            ScopeColumn(f.name, alias, i, f.type)
            for i, f in enumerate(d.schema) if i < n_vis
        ])
        return node, scope

    def _plan_table_func_ref(self, ref: A.TableFuncRef):
        """FROM generate_series(…) with constant args → Values leaf
        (reference: table function scan lowered to batch values when
        constant; src/frontend/src/optimizer/plan_node/logical_table_function.rs)."""
        from ..stream.project_set import TABLE_FUNC_KINDS, series_values
        name = ref.name.lower()
        if name not in TABLE_FUNC_KINDS:
            raise PlanError(f"unknown table function {ref.name!r}")
        binder = ExprBinder(Scope([]))
        args = []
        binder_types = []
        for a in ref.args:
            b = binder.bind(a)
            if not isinstance(b, Literal):
                raise PlanError(
                    f"FROM {name}(...) requires constant arguments")
            args.append(b.value)
            binder_types.append(b.type)
        from ..common.types import INT64 as _I64, VARCHAR
        if name == "regexp_split_to_table":
            out_t = VARCHAR
        elif name == "unnest":
            if not binder_types or not binder_types[0].is_list:
                raise PlanError("unnest() requires an array argument")
            out_t = binder_types[0].elem_type
        else:
            out_t = _I64
        vals = series_values(name, args)
        # series elements are physical scalars; literals carry python values
        vals = [None if v is None else out_t.to_python(v) for v in vals]
        rows = tuple((Literal(v, out_t),) for v in vals)
        alias = ref.alias or name
        schema = Schema((Field(alias, out_t),))
        node = PValues(schema=schema, pk=(), rows=rows)
        return node, Scope.of_schema(schema, alias)

    def _plan_window_tvf(self, tvf: A.WindowTVF):
        node, scope = self._plan_table_ref(tvf.table)
        tc = scope.resolve(tvf.time_col, None)
        if tc.type.kind != TIMESTAMP.kind:
            raise PlanError(f"window TVF time column must be timestamp")
        alias = tvf.alias or tvf.table.name

        def lit_us(e) -> int:
            b = ExprBinder(scope).bind(e)
            if not isinstance(b, Literal):
                raise PlanError("window TVF size/slide must be literal")
            return int(b.value)

        n_in = len(node.schema)
        if tvf.kind == "tumble":
            (size,) = map(lit_us, tvf.args)
            # TUMBLE = projection: all columns + window_start + window_end
            exprs = [InputRef(i, f.type) for i, f in enumerate(node.schema)]
            ws = call("tumble_start", InputRef(tc.index, tc.type),
                      Literal(size, TIMESTAMP))
            exprs.append(ws)
            exprs.append(call("add", ws, Literal(size, TIMESTAMP)))
            schema = Schema(tuple(node.schema) + (
                Field("window_start", TIMESTAMP), Field("window_end", TIMESTAMP)))
            node = PProject(schema=schema, pk=node.pk, input=node,
                            exprs=tuple(exprs))
        else:
            slide, size = map(lit_us, tvf.args)
            schema = Schema(tuple(node.schema) + (
                Field("window_start", TIMESTAMP), Field("window_end", TIMESTAMP)))
            # pk extends with window_start: one input row yields size/slide rows
            node = PHopWindow(schema=schema, pk=tuple(node.pk) + (n_in,),
                              input=node, time_col=tc.index, slide=slide,
                              size=size)
        new_scope = Scope(
            scope.columns + [
                ScopeColumn("window_start", alias, n_in, TIMESTAMP),
                ScopeColumn("window_end", alias, n_in + 1, TIMESTAMP),
            ])
        return node, new_scope

    def _plan_join(self, j: A.Join, pending_conjuncts=None):
        if j.temporal:
            return self._plan_temporal_join(j)
        left, lscope = self._plan_relation(j.left, pending_conjuncts)
        right, rscope = self._plan_relation(j.right, pending_conjuncts)
        n_left = len(left.schema)
        scope = lscope.concat(rscope, n_left)

        # split ON into equi-keys and residual condition
        lkeys, rkeys, residual = [], [], []
        if j.on is not None:
            for conj in _conjuncts(j.on):
                pair = self._equi_pair(conj, scope, n_left)
                if pair is not None:
                    lkeys.append(pair[0])
                    rkeys.append(pair[1])
                else:
                    residual.append(conj)
        if not lkeys and j.kind == "inner" and pending_conjuncts:
            # comma-syntax join: pull equality conjuncts out of WHERE
            # (consumed conjuncts no longer filter above the join)
            for conj in list(pending_conjuncts):
                pair = self._equi_pair(conj, scope, n_left)
                if pair is not None:
                    lkeys.append(pair[0])
                    rkeys.append(pair[1])
                    pending_conjuncts.remove(conj)
        if not lkeys:
            raise PlanError("join requires at least one equality condition "
                            "(nested-loop streaming join unsupported)")
        cond = None
        post_filters: list = []
        if residual:
            from ..expr.expr import uses_host_callback
            bound = [ExprBinder(scope).bind(c) for c in residual]
            for b in bound:
                if uses_host_callback(b):
                    # host-tier string predicates cannot run inside the
                    # jitted join core; for inner joins they are equivalent
                    # to a filter above the join
                    if j.kind != "inner":
                        raise PlanError(
                            "string predicates in outer-join conditions "
                            "are not supported; filter in a subquery")
                    post_filters.append(b)
                elif cond is None:
                    cond = b
                else:
                    cond = call("and", cond, b)

        schema = Schema(tuple(left.schema) + tuple(right.schema))
        pk = tuple(left.pk) + tuple(i + n_left for i in right.pk)
        node: PlanNode = PJoin(
            schema=schema, pk=pk, left=left, right=right,
            kind=j.kind, left_keys=tuple(lkeys),
            right_keys=tuple(rkeys), condition=cond)
        for b in post_filters:
            node = PFilter(schema=node.schema, pk=node.pk, input=node,
                           predicate=b)
        return node, scope

    def _plan_temporal_join(self, j: A.Join):
        """FOR SYSTEM_TIME AS OF PROCTIME(): right side must be a named
        table/MV; its current rows are probed, not streamed. The probe
        side must be append-only (a retraction's enrichment would be
        recomputed from the table's CURRENT rows and could fail to cancel
        the originally emitted rows)."""
        if j.kind not in ("inner", "left"):
            raise PlanError("temporal joins support INNER and LEFT only")
        if not isinstance(j.right, A.TableRef):
            raise PlanError("temporal join right side must be a table/MV")
        left, lscope = self._plan_relation(j.left)
        if not _plan_is_append_only(left):
            if self.lenient:
                import warnings
                warnings.warn(
                    "temporal join probe side is not append-only; the "
                    "job will fail at the first retraction (statement "
                    "predates the append-only rule)")
            else:
                raise PlanError(
                    "temporal join requires an append-only probe side "
                    "(sources / append-only tables through stateless "
                    "operators); this input can retract")
        kind, rdef = self.catalog.resolve_relation(j.right.name)
        if kind == "source":
            raise PlanError("temporal join right side must be materialized")
        alias = j.right.alias or j.right.name
        # scope = VISIBLE columns only (hidden '_' stream-key cols of an
        # MV stay out of name resolution, as in _plan_table_ref)
        n_vis = getattr(rdef, "n_visible", len(rdef.schema))
        rscope = Scope([
            ScopeColumn(f.name, alias, i, f.type)
            for i, f in enumerate(rdef.schema) if i < n_vis
        ])
        n_left = len(left.schema)
        scope = lscope.concat(rscope, n_left)
        lkeys, rkeys, residual = [], [], []
        for conj in _conjuncts(j.on) if j.on is not None else []:
            pair = self._equi_pair(conj, scope, n_left)
            if pair is not None:
                lkeys.append(pair[0])
                rkeys.append(pair[1])
            else:
                residual.append(conj)
        if not lkeys:
            raise PlanError("temporal join requires an equality condition")
        cond = None
        if residual:
            if j.kind == "left":
                raise PlanError("non-equi conditions on LEFT temporal "
                                "joins are not supported")
            bound = [ExprBinder(scope).bind(c) for c in residual]
            cond = bound[0]
            for b in bound[1:]:
                cond = call("and", cond, b)
        schema = Schema(tuple(left.schema) + tuple(rdef.schema))
        # stream key: the probe side's key + the table pk (a probe row can
        # match several table rows unless probing by full pk)
        pk = tuple(left.pk) + tuple(i + n_left for i in rdef.pk)
        return PTemporalJoin(
            schema=schema, pk=pk, input=left,
            right_kind="table" if kind == "table" else "mv",
            right_def=rdef, left_keys=tuple(lkeys), right_keys=tuple(rkeys),
            outer=j.kind == "left", condition=cond), scope

    def _equi_pair(self, conj, scope: Scope, n_left: int):
        if not (isinstance(conj, A.BinaryOp) and conj.op == "="):
            return None
        try:
            l = ExprBinder(scope).bind(conj.left)
            r = ExprBinder(scope).bind(conj.right)
        except BindError:
            return None
        if isinstance(l, InputRef) and isinstance(r, InputRef):
            if l.index < n_left <= r.index:
                return (l.index, r.index - n_left)
            if r.index < n_left <= l.index:
                return (r.index, l.index - n_left)
        return None

    # -- projection / aggregation ---------------------------------------------

    def _expand_stars(self, sel: A.Select, scope: Scope) -> list:
        items = []
        for item in sel.items:
            if isinstance(item.expr, A.Star):
                for c in scope.columns:
                    if item.expr.table is None or c.table == item.expr.table:
                        items.append(A.SelectItem(
                            A.ColumnRef(c.name, c.table), c.name))
            else:
                items.append(item)
        return items

    def _plan_projection(self, sel: A.Select, node: PlanNode, scope: Scope):
        items = self._expand_stars(sel, scope)
        exprs, fields = [], []
        for item in items:
            e = ExprBinder(scope).bind(item.expr)
            exprs.append(e)
            fields.append(Field(item.alias or self._auto_name(item.expr), e.type))
        # keep the stream key alive: append hidden pk columns not projected
        out_pk = []
        for pk_col in node.pk:
            found = None
            for i, e in enumerate(exprs):
                if isinstance(e, InputRef) and e.index == pk_col:
                    found = i
                    break
            if found is None:
                exprs.append(InputRef(pk_col, node.schema[pk_col].type))
                fields.append(Field(f"_pk{len(out_pk)}", node.schema[pk_col].type))
                found = len(exprs) - 1
            out_pk.append(found)
        proj = PProject(schema=Schema(tuple(fields)), pk=tuple(out_pk),
                        input=node, exprs=tuple(exprs))
        new_scope = Scope([
            ScopeColumn(f.name, None, i, f.type)
            for i, f in enumerate(proj.schema)
        ])
        return proj, new_scope

    def _plan_agg(self, sel: A.Select, node: PlanNode, scope: Scope):
        # 1. bind group keys
        group_exprs = [ExprBinder(scope).bind(g) for g in sel.group_by]
        # 2. bind select items + having with agg collection
        aggs: list[BoundAgg] = []
        items = self._expand_stars(sel, scope)
        bound_items = []
        for item in items:
            b = ExprBinder(scope, agg_ctx=aggs).bind(item.expr)
            bound_items.append((b, item.alias or self._auto_name(item.expr)))
        bound_having = None
        having_dyn: list = []  # (bound_lhs_tree, cmp_fn_name, subquery)
        if sel.having is not None:
            plain_h: list = []
            for conj in _conjuncts(sel.having):
                if self._has_subquery(conj):
                    # HAVING agg CMP (SELECT …) → DynamicFilter above the
                    # agg (reference: the same Apply rewrite as WHERE-level
                    # scalar subqueries; q102 shape). Bind the agg side NOW
                    # so its agg call registers before the pre-projection.
                    if not (isinstance(conj, A.BinaryOp)
                            and conj.op in _CMP_TO_FN):
                        raise PlanError("HAVING subquery only supported as "
                                        "'agg CMP (SELECT …)'")
                    lsub = isinstance(conj.left, A.ScalarSubquery)
                    rsub = isinstance(conj.right, A.ScalarSubquery)
                    if lsub == rsub:
                        raise PlanError(
                            "exactly one side must be a scalar subquery")
                    col_ast = conj.right if lsub else conj.left
                    sub = conj.left if lsub else conj.right
                    op = _CMP_FLIP[conj.op] if lsub else conj.op
                    lhs_b = ExprBinder(scope, agg_ctx=aggs).bind(col_ast)
                    having_dyn.append((lhs_b, _CMP_TO_FN[op], sub))
                else:
                    plain_h.append(conj)
            if plain_h:
                e = plain_h[0]
                for c in plain_h[1:]:
                    e = A.BinaryOp("AND", e, c)
                bound_having = ExprBinder(scope, agg_ctx=aggs).bind(e)

        # 3. pre-projection: group keys first, then agg args
        pre_exprs = list(group_exprs)
        for a in aggs:
            if hasattr(a, "arg_expr"):
                a.call = dataclasses.replace(a.call, arg=len(pre_exprs))
                pre_exprs.append(a.arg_expr)  # type: ignore[attr-defined]
            elif a.call.arg >= 0:
                # remap plain column arg into pre-projection position
                pre_exprs.append(InputRef(a.call.arg,
                                          node.schema[a.call.arg].type))
                a.call = dataclasses.replace(a.call, arg=len(pre_exprs) - 1)
        pre_fields = [
            Field(f"k{i}", e.type) for i, e in enumerate(group_exprs)
        ] + [
            Field(f"a{i}", e.type)
            for i, e in enumerate(pre_exprs[len(group_exprs):])
        ]
        pre = PProject(schema=Schema(tuple(pre_fields)), pk=(), input=node,
                       exprs=tuple(pre_exprs))

        # 4. the agg node: output = group keys ++ agg outputs
        nk = len(group_exprs)
        agg_fields = tuple(
            Field(f"k{i}", e.type) for i, e in enumerate(group_exprs)
        ) + tuple(
            Field(f"agg{i}", a.call.output_type) for i, a in enumerate(aggs)
        )
        agg_node = PAgg(
            schema=Schema(agg_fields), pk=tuple(range(nk)), input=pre,
            group_keys=tuple(range(nk)),
            agg_calls=tuple(a.call for a in aggs),
            append_only_input=_plan_is_append_only(pre),
            eowc=sel.emit_on_window_close)

        # 5. post-projection: rewrite select items over agg output
        def agg_ref(i: int) -> Expr:
            return InputRef(nk + i, aggs[i].call.output_type)

        def rewrite_tree(e: Expr) -> Expr:
            # replace group-key subexpressions first, then agg placeholders
            for gi, g in enumerate(group_exprs):
                if _expr_eq(e, g):
                    return InputRef(gi, g.type)
            if isinstance(e, _AggPlaceholder):
                return agg_ref(e.agg_index)
            if isinstance(e, FunctionCall):
                return dataclasses.replace(
                    e, args=tuple(rewrite_tree(a) for a in e.args))
            from ..expr.expr import Cast as RCast
            if isinstance(e, RCast):
                return dataclasses.replace(e, arg=rewrite_tree(e.arg))
            if isinstance(e, InputRef):
                raise PlanError(
                    f"column ${e.index} must appear in GROUP BY or an "
                    "aggregate")
            return e

        post_node: PlanNode = agg_node
        if bound_having is not None:
            post_node = PFilter(schema=agg_node.schema, pk=agg_node.pk,
                                input=post_node,
                                predicate=rewrite_tree(bound_having))
        for lhs_b, cmp_fn, sub in having_dyn:
            key = rewrite_tree(lhs_b)
            if not isinstance(key, InputRef):
                raise PlanError("HAVING dynamic-filter side must be a "
                                "single aggregate or group key")
            right_plan = self.plan_select(sub.query)
            if len(right_plan.schema) < 1:
                raise PlanError("scalar subquery must produce one column")
            post_node = PDynFilter(
                schema=post_node.schema, pk=post_node.pk, input=post_node,
                right=right_plan, key_col=key.index, cmp=cmp_fn)
        out_exprs, out_fields = [], []
        for b, name in bound_items:
            e = rewrite_tree(b)
            out_exprs.append(e)
            out_fields.append(Field(name, e.type))
        out_pk = []
        for pk_col in agg_node.pk:
            found = None
            for i, e in enumerate(out_exprs):
                if isinstance(e, InputRef) and e.index == pk_col:
                    found = i
                    break
            if found is None:
                out_exprs.append(InputRef(pk_col, agg_node.schema[pk_col].type))
                out_fields.append(
                    Field(f"_pk{len(out_pk)}", agg_node.schema[pk_col].type))
                found = len(out_exprs) - 1
            out_pk.append(found)
        proj = PProject(schema=Schema(tuple(out_fields)), pk=tuple(out_pk),
                        input=post_node, exprs=tuple(out_exprs))
        new_scope = Scope([
            ScopeColumn(f.name, None, i, f.type)
            for i, f in enumerate(proj.schema)
        ])
        return proj, new_scope

    def _plan_over_window(self, sel: A.Select, node: PlanNode, scope: Scope):
        """SELECT with OVER clauses → pre-projection (input cols + hidden
        partition/order/arg exprs) → POverWindow → post-projection."""
        from ..stream.over_window import WindowCall
        wins: list[BoundWindow] = []
        items = self._expand_stars(sel, scope)
        bound_items = []
        for item in items:
            b = ExprBinder(scope, win_ctx=wins).bind(item.expr)
            bound_items.append((b, item.alias or self._auto_name(item.expr)))
        first = wins[0]
        for w in wins[1:]:
            same = (len(w.partition_exprs) == len(first.partition_exprs)
                    and all(_expr_eq(a, b) for a, b in
                            zip(w.partition_exprs, first.partition_exprs))
                    and len(w.order_exprs) == len(first.order_exprs)
                    and all(_expr_eq(a[0], b[0]) and a[1:] == b[1:]
                            for a, b in
                            zip(w.order_exprs, first.order_exprs)))
            if not same:
                raise PlanError("all window functions in one SELECT must "
                                "share PARTITION BY / ORDER BY")

        pre_exprs: list[Expr] = [
            InputRef(i, f.type) for i, f in enumerate(node.schema)]

        def col_of(e: Expr) -> int:
            for i, pe in enumerate(pre_exprs):
                if _expr_eq(pe, e):
                    return i
            pre_exprs.append(e)
            return len(pre_exprs) - 1

        part_idx = tuple(col_of(p) for p in first.partition_exprs)
        order_specs = tuple(
            OrderSpec(col_of(oe), desc, nulls_last,
                      is_string=oe.type.is_string)
            for (oe, desc, nulls_last) in first.order_exprs)
        calls = tuple(
            WindowCall(
                kind=w.kind, output_type=w.output_type,
                arg=col_of(w.arg_expr) if w.arg_expr is not None else -1,
                offset=w.offset, partition_by=part_idx,
                order_by=order_specs)
            for w in wins)
        n_base = len(node.schema)
        if len(pre_exprs) > n_base:
            pre_schema = Schema(tuple(node.schema) + tuple(
                Field(f"_w{i}", e.type)
                for i, e in enumerate(pre_exprs[n_base:])))
            pre: PlanNode = PProject(schema=pre_schema, pk=node.pk,
                                     input=node, exprs=tuple(pre_exprs))
        else:
            pre = node
        n_in = len(pre.schema)
        win_schema = Schema(tuple(pre.schema) + tuple(
            Field(f"_win{i}", c.output_type) for i, c in enumerate(calls)))
        wnode = POverWindow(schema=win_schema, pk=pre.pk, input=pre,
                            calls=calls, eowc=sel.emit_on_window_close)

        def rw(e: Expr) -> Expr:
            if isinstance(e, _WindowPlaceholder):
                return InputRef(n_in + e.win_index, e.type)
            if isinstance(e, FunctionCall):
                return dataclasses.replace(
                    e, args=tuple(rw(a) for a in e.args))
            from ..expr.expr import Cast as RCast
            if isinstance(e, RCast):
                return dataclasses.replace(e, arg=rw(e.arg))
            return e

        out_exprs, out_fields = [], []
        for b, name in bound_items:
            e = rw(b)
            out_exprs.append(e)
            out_fields.append(Field(name, e.type))
        out_pk = []
        for pk_col in wnode.pk:
            found = None
            for i, e in enumerate(out_exprs):
                if isinstance(e, InputRef) and e.index == pk_col:
                    found = i
                    break
            if found is None:
                out_exprs.append(InputRef(pk_col, win_schema[pk_col].type))
                out_fields.append(
                    Field(f"_pk{len(out_pk)}", win_schema[pk_col].type))
                found = len(out_exprs) - 1
            out_pk.append(found)
        proj = PProject(schema=Schema(tuple(out_fields)), pk=tuple(out_pk),
                        input=wnode, exprs=tuple(out_exprs))
        new_scope = Scope([
            ScopeColumn(f.name, None, i, f.type)
            for i, f in enumerate(proj.schema)
        ])
        return proj, new_scope

    # -- TopN / dynamic filter / misc -----------------------------------------

    def _plan_topn(self, sel: A.Select, node: PlanNode, scope: Scope):
        order = []
        for oi in sel.order_by:
            b = ExprBinder(scope).bind(oi.expr)
            if not isinstance(b, InputRef):
                raise PlanError("ORDER BY expression must be an output column")
            nulls_last = oi.nulls_last
            if nulls_last is None:
                nulls_last = not oi.desc     # PG default
            order.append(OrderSpec(b.index, oi.desc, nulls_last,
                                   is_string=b.type.is_string))
        if sel.limit is None:
            # bare ORDER BY on an MV is a presentation property; keep plan
            return node
        return PTopN(schema=node.schema, pk=node.pk, input=node,
                     order=tuple(order), limit=sel.limit,
                     offset=sel.offset or 0, with_ties=sel.with_ties)

    def _plan_dynamic_filter(self, conj, node: PlanNode, scope: Scope):
        if not (isinstance(conj, A.BinaryOp) and conj.op in _CMP_TO_FN):
            raise PlanError(
                "subquery only supported as 'col CMP (SELECT ...)'")
        lsub = isinstance(conj.left, A.ScalarSubquery)
        rsub = isinstance(conj.right, A.ScalarSubquery)
        if lsub == rsub:
            raise PlanError("exactly one side must be a scalar subquery")
        col_ast = conj.right if lsub else conj.left
        sub = conj.left if lsub else conj.right
        op = _CMP_FLIP[conj.op] if lsub else conj.op
        b = ExprBinder(scope).bind(col_ast)
        if not isinstance(b, InputRef):
            raise PlanError("dynamic filter LHS must be a plain column")
        right_plan = self.plan_select(sub.query)
        if len(right_plan.schema) < 1:
            raise PlanError("scalar subquery must produce one column")
        return PDynFilter(schema=node.schema, pk=node.pk, input=node,
                          right=right_plan, key_col=b.index,
                          cmp=_CMP_TO_FN[op])

    def _plan_in_subquery(self, conj: A.InSubquery, node: PlanNode,
                          scope: Scope) -> PlanNode:
        b = ExprBinder(scope).bind(conj.expr)
        if not isinstance(b, InputRef):
            raise PlanError("IN (SELECT …) operand must be a plain column")
        sub = self.plan_select(conj.query)
        n_visible = sum(1 for f in sub.schema
                        if not f.name.startswith("_"))
        if n_visible != 1 or not sub.schema[0].name or \
                sub.schema[0].name.startswith("_"):
            raise PlanError("IN subquery must produce exactly one column")
        # hidden stream-key columns (appended by the planner) ride along
        # as the semi-join state's pk; only column 0 joins
        if conj.negated:
            # PG NOT IN NULL semantics: a NULL probe value never passes
            # (x <> NULL is unknown), so filter it below the join; a NULL
            # in the subquery means NO row passes — the anti join carries
            # ``null_aware`` so each engine enforces it (batch: emit
            # nothing; streaming: reject loudly rather than diverge).
            # KNOWN divergence: PG keeps a NULL probe row when the
            # subquery is EMPTY (NOT IN over the empty set is TRUE); the
            # static filter drops it regardless. Incrementally exact
            # behavior would retract those rows on the subquery's
            # empty→non-empty transition — out of scope, and the corner
            # (NULL probe AND always-empty subquery) is documented here
            # rather than silently wrong in the common case.
            node = PFilter(schema=node.schema, pk=node.pk, input=node,
                           predicate=call("is_not_null", b))
            return PJoin(schema=node.schema, pk=node.pk, left=node,
                         right=sub, kind="left_anti",
                         left_keys=(b.index,), right_keys=(0,),
                         condition=None, null_aware=True)
        return PJoin(schema=node.schema, pk=node.pk, left=node, right=sub,
                     kind="left_semi", left_keys=(b.index,), right_keys=(0,),
                     condition=None)

    def _plan_no_from(self, sel: A.Select) -> PlanNode:
        binder = ExprBinder(Scope([]))
        row = tuple(binder.bind(i.expr) for i in sel.items)
        from ..stream.project_set import TableFuncCall, series_values
        if len(row) == 1 and isinstance(row[0], TableFuncCall):
            # FROM-less set-returning select: SELECT unnest(ARRAY[…])
            tf = row[0]
            if not all(isinstance(a, Literal) for a in tf.args):
                raise PlanError(
                    "set-returning function without FROM requires "
                    "constant arguments")
            vals = series_values(tf.name, [a.value for a in tf.args])
            out_t = tf.type
            name = sel.items[0].alias or tf.name
            lit_rows = tuple(
                (Literal(None if v is None else out_t.to_python(v),
                         out_t),) for v in vals)
            return PValues(schema=Schema((Field(name, out_t),)), pk=(),
                           rows=lit_rows)
        fields = tuple(
            Field(item.alias or self._auto_name(item.expr), e.type)
            for item, e in zip(sel.items, row))
        return PValues(schema=Schema(fields), pk=(), rows=(row,))

    # -- small helpers --------------------------------------------------------

    def _has_subquery(self, e) -> bool:
        if isinstance(e, A.ScalarSubquery):
            return True
        if isinstance(e, A.BinaryOp):
            return self._has_subquery(e.left) or self._has_subquery(e.right)
        if isinstance(e, A.UnaryOp):
            return self._has_subquery(e.operand)
        return False

    def _select_has_aggs(self, sel: A.Select) -> bool:
        def walk(e) -> bool:
            if isinstance(e, A.FuncCall):
                if e.name.lower() in AGG_KINDS:
                    return True
                return any(walk(a) for a in e.args)
            if isinstance(e, A.BinaryOp):
                return walk(e.left) or walk(e.right)
            if isinstance(e, A.UnaryOp):
                return walk(e.operand)
            if isinstance(e, A.Case):
                return any(walk(c) or walk(r) for c, r in e.branches) or (
                    e.else_result is not None and walk(e.else_result))
            if isinstance(e, A.Cast):
                return walk(e.expr)
            return False
        return any(walk(i.expr) for i in sel.items
                   if not isinstance(i.expr, A.Star)) or (
            sel.having is not None and walk(sel.having))

    def _plan_project_set(self, sel: A.Select, node: PlanNode, scope: Scope):
        """Select list containing a set-returning function → PProjectSet.
        The table function must be a top-level select item; its elements
        land in that output column, other items replicate."""
        from ..stream.project_set import TableFuncCall
        items = self._expand_stars(sel, scope)
        exprs, fields = [], []
        n_tf = 0
        for item in items:
            b = ExprBinder(scope).bind(item.expr)
            if isinstance(b, TableFuncCall):
                n_tf += 1
            elif contains_placeholder(b, TableFuncCall):
                raise PlanError("set-returning functions must be top-level "
                                "select items")
            exprs.append(b)
            fields.append(Field(item.alias or self._auto_name(item.expr),
                                b.type))
        if n_tf != 1:
            raise PlanError("exactly one set-returning function per SELECT "
                            "is supported")
        # stream key: input pk passthrough + hidden element index
        out_pk = []
        for pk_col in node.pk:
            found = None
            for i, e in enumerate(exprs):
                if isinstance(e, InputRef) and e.index == pk_col:
                    found = i
                    break
            if found is None:
                exprs.append(InputRef(pk_col, node.schema[pk_col].type))
                fields.append(
                    Field(f"_pk{len(out_pk)}", node.schema[pk_col].type))
                found = len(exprs) - 1
            out_pk.append(found)
        from ..common.types import INT64 as _I64
        exprs.append(Literal(0, _I64))       # executor fills the index
        fields.append(Field("_pidx", _I64))
        out_pk.append(len(exprs) - 1)
        ps = PProjectSet(schema=Schema(tuple(fields)), pk=tuple(out_pk),
                         input=node, exprs=tuple(exprs))
        new_scope = Scope([
            ScopeColumn(f.name, None, i, f.type)
            for i, f in enumerate(ps.schema)
        ])
        return ps, new_scope

    def _select_has_table_funcs(self, sel: A.Select) -> bool:
        from ..stream.project_set import TABLE_FUNC_KINDS

        def walk(e) -> bool:
            if isinstance(e, A.FuncCall):
                return (e.name.lower() in TABLE_FUNC_KINDS
                        or any(walk(a) for a in e.args))
            if isinstance(e, A.BinaryOp):
                return walk(e.left) or walk(e.right)
            if isinstance(e, A.UnaryOp):
                return walk(e.operand)
            if isinstance(e, A.Cast):
                return walk(e.expr)
            return False
        return any(walk(i.expr) for i in sel.items
                   if not isinstance(i.expr, A.Star))

    def _select_has_windows(self, sel: A.Select) -> bool:
        def walk(e) -> bool:
            if isinstance(e, A.WindowFunc):
                return True
            if isinstance(e, A.FuncCall):
                return any(walk(a) for a in e.args)
            if isinstance(e, A.BinaryOp):
                return walk(e.left) or walk(e.right)
            if isinstance(e, A.UnaryOp):
                return walk(e.operand)
            if isinstance(e, A.Case):
                return any(walk(c) or walk(r) for c, r in e.branches) or (
                    e.else_result is not None and walk(e.else_result))
            if isinstance(e, A.Cast):
                return walk(e.expr)
            return False
        return any(walk(i.expr) for i in sel.items
                   if not isinstance(i.expr, A.Star))

    def _auto_name(self, e) -> str:
        if isinstance(e, A.ColumnRef):
            return e.name
        if isinstance(e, A.FuncCall):
            return e.name.lower()
        if isinstance(e, A.WindowFunc):
            return e.func.name.lower()
        return "?column?"


def _plan_is_append_only(plan: PlanNode) -> bool:
    """Conservative: true only for sources/append-only tables flowing
    through stateless row-preserving operators (reference: append-only
    derivation in the optimizer's stream properties)."""
    if isinstance(plan, PSource):
        return True
    if isinstance(plan, PTableScan):
        # DELETE/UPDATE DML can retract from ordinary tables; only
        # declared APPEND ONLY tables are safe probe sides
        return bool(getattr(plan.table, "append_only", False))
    if isinstance(plan, (PProject, PFilter, PHopWindow)):
        return _plan_is_append_only(plan.input)
    if isinstance(plan, PTemporalJoin):
        return _plan_is_append_only(plan.input)
    if isinstance(plan, PUnion):
        return all(_plan_is_append_only(i) for i in plan.inputs)
    if isinstance(plan, PJoin):
        # an inner/semi join of append-only inputs never retracts a row it
        # emitted (no deletes arrive on either side); every outer/anti
        # shape can retract its padded or emitted rows
        return (plan.kind in ("inner", "left_semi")
                and _plan_is_append_only(plan.left)
                and _plan_is_append_only(plan.right))
    return False


def _expr_eq(a: Expr, b: Expr) -> bool:
    """Structural equality of bound expressions (Expr overloads __eq__ for
    SQL sugar, so compare explicitly)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, InputRef):
        return a.index == b.index
    if isinstance(a, Literal):
        return a.value == b.value and a.type.kind == b.type.kind
    if isinstance(a, FunctionCall):
        return (a.name == b.name and len(a.args) == len(b.args)
                and all(_expr_eq(x, y) for x, y in zip(a.args, b.args)))
    from ..expr.expr import Cast as RCast
    if isinstance(a, RCast):
        return a.type.kind == b.type.kind and _expr_eq(a.arg, b.arg)
    return a is b
