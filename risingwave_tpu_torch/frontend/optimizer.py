"""Copy of ``risingwave_tpu/frontend/optimizer.py``: the reference's text,
its relative imports resolving to the port's modules.

Logical optimizer: rule engine + column pruning over the stream plan.

Counterpart of the reference's optimizer pass pipeline
(reference: src/frontend/src/optimizer/logical_optimization.rs — ordered
stages, each a set of rules applied to fixpoint; rule trait at
src/frontend/src/optimizer/rule/mod.rs). The reference ships 45+ rules
over a Rust plan-node hierarchy; here the same architecture is scaled to
the plan tree in ``planner.py``:

* ``Rule`` — one local rewrite: ``apply(node) -> Optional[PlanNode]``
  (None = no match). Rules never inspect more than the node and its
  children, exactly like the reference's ``Rule::apply``.
* ``rewrite_fixpoint`` — bottom-up loop applying a stage's rules until
  no rule fires (the reference's ``HeuristicOptimizer`` with
  ``ApplyOrder::BottomUp``).
* ``prune_columns`` — the column-pruning pass (reference:
  ``prune_col`` on every plan node, optimizer/plan_node/*.rs): a
  top-down required-column analysis that narrows every operator's
  output to what its consumers read, inserting projections over wide
  leaves. On a TPU this is not cosmetic: chunk columns are device
  arrays, so every pruned column is HBM bandwidth saved in every
  executor step downstream.

Pushdown rules shipped (reference names in parens):

* FilterMerge          (``LogicalFilter::merge``)
* FilterProjectTranspose  (PushCalculationOfJoinRule / filter-project)
* FilterJoinPushdown   (``FilterJoinRule`` — conjunct routing by side,
                        outer-join safety table)
* FilterAggTranspose   (``FilterAggRule`` — group-key conjuncts only)
* FilterUnionTranspose (``FilterUnionRule``)
* ProjectMerge         (``ProjectMergeRule``)

Scalar-subquery unnesting lives in the planner (DynamicFilter lowering
for comparisons, constant-key left join otherwise — the uncorrelated
half of the reference's ApplyToJoinRule family); see
``planner._plan_dynamic_filter`` / ``_plan_scalar_subqueries``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..expr.expr import Cast, Expr, FunctionCall, InputRef, Literal, call
from ..ops.topn import OrderSpec
from . import planner as P

# -- expression utilities -----------------------------------------------------


def _expr_fields(e: Expr):
    """(field_name, value) pairs of e's dataclass fields."""
    return [(f.name, getattr(e, f.name)) for f in dataclasses.fields(e)]


def map_expr(e: Expr, fn) -> Expr:
    """Rebuild ``e`` with ``fn`` applied to every direct child Expr
    (generic over all Expr dataclasses: FunctionCall.args, Cast.arg,
    TableFuncCall.args, ...)."""
    changes = {}
    for name, v in _expr_fields(e):
        if isinstance(v, Expr):
            nv = fn(v)
            if nv is not v:
                changes[name] = nv
        elif isinstance(v, tuple) and any(isinstance(x, Expr) for x in v):
            nv = tuple(fn(x) if isinstance(x, Expr) else x for x in v)
            # identity compare: Expr overloads __eq__ into SQL sugar, so
            # tuple != would silently report "unchanged"
            if any(a is not b for a, b in zip(nv, v)):
                changes[name] = nv
    return dataclasses.replace(e, **changes) if changes else e


def expr_refs(e: Expr) -> frozenset:
    """Set of input column indices referenced by ``e``."""
    if isinstance(e, InputRef):
        return frozenset((e.index,))
    out: set = set()
    for _, v in _expr_fields(e):
        if isinstance(v, Expr):
            out |= expr_refs(v)
        elif isinstance(v, tuple):
            for x in v:
                if isinstance(x, Expr):
                    out |= expr_refs(x)
    return frozenset(out)


def remap_expr(e: Expr, mapping: dict) -> Expr:
    """Renumber every InputRef through ``mapping`` (old index -> new)."""
    if isinstance(e, InputRef):
        return InputRef(mapping[e.index], e.type)
    return map_expr(e, lambda c: remap_expr(c, mapping))


def subst_expr(e: Expr, exprs: Sequence[Expr]) -> Expr:
    """Replace every InputRef i with ``exprs[i]`` (projection compose)."""
    if isinstance(e, InputRef):
        return exprs[e.index]
    return map_expr(e, lambda c: subst_expr(c, exprs))


def conjuncts_of(e: Expr) -> list:
    if isinstance(e, FunctionCall) and e.name == "and":
        out: list = []
        for a in e.args:
            out.extend(conjuncts_of(a))
        return out
    return [e]


def conjoin(cs: Sequence[Expr]) -> Expr:
    out = cs[0]
    for c in cs[1:]:
        out = call("and", out, c)
    return out


# -- rule engine --------------------------------------------------------------


class Rule:
    """One local rewrite. ``apply`` returns the replacement node or None."""

    name = "rule"

    def apply(self, node: P.PlanNode) -> Optional[P.PlanNode]:
        raise NotImplementedError


_CHILD_FIELDS = {
    P.PProject: ("input",), P.PFilter: ("input",), P.PHopWindow: ("input",),
    P.PAgg: ("input",), P.PTopN: ("input",), P.POverWindow: ("input",),
    P.PProjectSet: ("input",), P.PTemporalJoin: ("input",),
    P.PJoin: ("left", "right"), P.PDynFilter: ("input", "right"),
}


def _with_children(node: P.PlanNode, kids: Sequence[P.PlanNode]) -> P.PlanNode:
    if isinstance(node, P.PUnion):
        return dataclasses.replace(node, inputs=tuple(kids))
    names = _CHILD_FIELDS.get(type(node))
    if not names:
        return node
    return dataclasses.replace(node, **dict(zip(names, kids)))


def rewrite_fixpoint(plan: P.PlanNode, rules: Sequence[Rule],
                     max_passes: int = 32) -> P.PlanNode:
    """Bottom-up rewrite to fixpoint. Each pass rewrites children first,
    then offers the node to every rule; repeated until a full pass makes
    no change (bounded — every shipped rule strictly reduces node count
    or moves filters downward, so this converges well before the cap)."""

    def one_pass(node: P.PlanNode):
        changed = False
        kids = list(node.children)
        if kids:
            new_kids = []
            for k in kids:
                nk, ch = one_pass(k)
                changed |= ch
                new_kids.append(nk)
            if changed:
                node = _with_children(node, new_kids)
        for r in rules:
            repl = r.apply(node)
            if repl is not None:
                return repl, True
        return node, changed

    for _ in range(max_passes):
        plan, changed = one_pass(plan)
        if not changed:
            break
    return plan


# -- pushdown rules -----------------------------------------------------------


class FilterMerge(Rule):
    """Filter(Filter(x, p1), p2) -> Filter(x, p1 AND p2)."""

    name = "filter_merge"

    def apply(self, node):
        if isinstance(node, P.PFilter) and isinstance(node.input, P.PFilter):
            inner = node.input
            return P.PFilter(
                schema=node.schema, pk=node.pk, input=inner.input,
                predicate=call("and", inner.predicate, node.predicate))
        return None


class FilterProjectTranspose(Rule):
    """Filter(Project(x, es), p) -> Project(Filter(x, p∘es), es).

    Sound because every projection expr is pure; the predicate is
    rewritten by substituting each InputRef with the projection expr it
    names, then evaluated against the projection's input."""

    name = "filter_project"

    def apply(self, node):
        if not (isinstance(node, P.PFilter)
                and isinstance(node.input, P.PProject)):
            return None
        proj = node.input
        pred = subst_expr(node.predicate, proj.exprs)
        return dataclasses.replace(
            proj,
            input=P.PFilter(schema=proj.input.schema, pk=proj.input.pk,
                            input=proj.input, predicate=pred))


#: join kinds through which a predicate on one side may be pushed into
#: that side's input. For outer joins only the PRESERVED side's
#: predicates push (a null-supplying side's predicate above the join also
#: rejects the padded rows, which pushing would instead convert into
#: pass-through padded rows — reference: FilterJoinRule's
#: can_push_left_from_filter / can_push_right_from_filter).
_PUSH_LEFT_KINDS = {"inner", "left", "left_semi", "left_anti"}
_PUSH_RIGHT_KINDS = {"inner", "right"}


class FilterJoinPushdown(Rule):
    """Route filter conjuncts above a join into the side they reference."""

    name = "filter_join"

    def apply(self, node):
        if not (isinstance(node, P.PFilter) and isinstance(node.input, P.PJoin)):
            return None
        j = node.input
        nl = len(j.left.schema)
        to_left, to_right, keep = [], [], []
        for c in conjuncts_of(node.predicate):
            refs = expr_refs(c)
            if refs and max(refs) < nl and j.kind in _PUSH_LEFT_KINDS:
                to_left.append(c)
            elif refs and min(refs) >= nl and j.kind in _PUSH_RIGHT_KINDS:
                to_right.append(remap_expr(c, {i: i - nl for i in refs}))
            else:
                keep.append(c)
        if not to_left and not to_right:
            return None
        left, right = j.left, j.right
        if to_left:
            left = P.PFilter(schema=left.schema, pk=left.pk, input=left,
                             predicate=conjoin(to_left))
        if to_right:
            right = P.PFilter(schema=right.schema, pk=right.pk, input=right,
                              predicate=conjoin(to_right))
        new_join = dataclasses.replace(j, left=left, right=right)
        if keep:
            return P.PFilter(schema=node.schema, pk=node.pk, input=new_join,
                             predicate=conjoin(keep))
        return new_join


class FilterAggTranspose(Rule):
    """Push group-key-only conjuncts below a hash agg (a group exists
    above iff its key rows exist below, so key predicates commute with
    grouping; agg-output predicates — HAVING — must stay above)."""

    name = "filter_agg"

    def apply(self, node):
        if not (isinstance(node, P.PFilter) and isinstance(node.input, P.PAgg)):
            return None
        agg = node.input
        nk = len(agg.group_keys)
        if nk == 0:
            return None
        down, keep = [], []
        for c in conjuncts_of(node.predicate):
            refs = expr_refs(c)
            if refs and max(refs) < nk:
                down.append(remap_expr(
                    c, {i: agg.group_keys[i] for i in refs}))
            else:
                keep.append(c)
        if not down:
            return None
        inp = P.PFilter(schema=agg.input.schema, pk=agg.input.pk,
                        input=agg.input, predicate=conjoin(down))
        new_agg = dataclasses.replace(agg, input=inp)
        if keep:
            return P.PFilter(schema=node.schema, pk=node.pk, input=new_agg,
                             predicate=conjoin(keep))
        return new_agg


class FilterUnionTranspose(Rule):
    """Filter(UnionAll(xs), p) -> UnionAll(Filter(x, p)...)."""

    name = "filter_union"

    def apply(self, node):
        if not (isinstance(node, P.PFilter) and isinstance(node.input, P.PUnion)):
            return None
        u = node.input
        return dataclasses.replace(u, inputs=tuple(
            P.PFilter(schema=i.schema, pk=i.pk, input=i,
                      predicate=node.predicate)
            for i in u.inputs))


class ProjectMerge(Rule):
    """Project(Project(x, inner), outer) -> Project(x, outer∘inner)."""

    name = "project_merge"

    def apply(self, node):
        if not (isinstance(node, P.PProject)
                and isinstance(node.input, P.PProject)):
            return None
        inner = node.input
        return dataclasses.replace(
            node, input=inner.input,
            exprs=tuple(subst_expr(e, inner.exprs) for e in node.exprs))


class RankFilterToGroupTopN(Rule):
    """``rownum <= k`` over a rank-family window → GroupTopN.

    Matches the planner's over-window shape  PProject(outer) → PFilter
    (rank CMP k) → PProject(post) → POverWindow([one rank-kind call])
    and replaces the window with  PTopN(group_by=partition,
    order=order, limit=k, with_ties = kind=='rank')  over the window's
    input; the dead rank column becomes a NULL literal for pruning to
    remove. This turns q9/q18-style "top row per key" from O(partition)
    window recompute per barrier into incremental per-group TopN
    maintenance (reference: over_window_to_topn_rule.rs; e2e q18 "covers
    group top-n").

    Runs BEFORE the pushdown stage: FilterProjectTranspose would
    otherwise dissolve the exact shape this matches."""

    name = "rank_filter_to_group_topn"

    def apply(self, node):
        if not isinstance(node, P.PProject):
            return None
        filt = node.input
        if not isinstance(filt, P.PFilter):
            return None
        post = filt.input
        if not isinstance(post, P.PProject):
            return None
        win = post.input
        if not isinstance(win, P.POverWindow) or win.eowc:
            return None
        if len(win.calls) != 1:
            return None
        wcall = win.calls[0]
        if wcall.kind not in ("row_number", "rank"):
            return None
        n_in = len(win.input.schema)
        rank_cols = [i for i, e in enumerate(post.exprs)
                     if isinstance(e, InputRef) and e.index == n_in]
        if len(rank_cols) != 1:
            return None
        rank_col = rank_cols[0]
        for i, e in enumerate(post.exprs):
            if i != rank_col and any(r >= n_in for r in expr_refs(e)):
                return None
        limit = self._limit_from_pred(filt.predicate, rank_col,
                                      wcall.kind)
        if limit is None:
            return None
        for e in node.exprs:                  # rank must be dead above
            if rank_col in expr_refs(e):
                return None
        topn = P.PTopN(
            schema=win.input.schema, pk=win.input.pk, input=win.input,
            order=tuple(wcall.order_by), limit=limit, offset=0,
            with_ties=(wcall.kind == "rank"),
            group_by=tuple(wcall.partition_by))
        from ..common.types import INT64
        new_exprs = list(post.exprs)
        new_exprs[rank_col] = Literal(None, INT64)
        new_post = dataclasses.replace(post, input=topn,
                                       exprs=tuple(new_exprs))
        return dataclasses.replace(node, input=new_post)

    @staticmethod
    def _limit_from_pred(pred, rank_col: int, kind: str):
        if not isinstance(pred, FunctionCall) or len(pred.args) != 2:
            return None
        a, b = pred.args
        if not (isinstance(a, InputRef) and a.index == rank_col
                and isinstance(b, Literal)
                and isinstance(b.value, int)):
            return None
        if pred.name == "less_than_or_equal" and b.value >= 1:
            return b.value
        if pred.name == "less_than" and b.value > 1:
            return b.value - 1
        if pred.name == "equal" and b.value == 1:
            return 1
        return None


#: shape-dependent rewrites that must see the planner's raw tree
PREPASS_RULES = (RankFilterToGroupTopN(),)

PUSHDOWN_RULES = (
    FilterMerge(), FilterProjectTranspose(), FilterJoinPushdown(),
    FilterAggTranspose(), FilterUnionTranspose(),
)
CLEANUP_RULES = (ProjectMerge(), FilterMerge())


# -- column pruning -----------------------------------------------------------


def _ident(n: int) -> dict:
    return {i: i for i in range(n)}


def prune_columns(plan: P.PlanNode) -> P.PlanNode:
    """Top-down required-column analysis. The root keeps its full schema
    (it is the MV / query output contract); interior operators narrow to
    the columns their consumers actually read, and wide leaves gain a
    narrowing projection."""
    node, _ = _prune(plan, set(range(len(plan.schema))))
    return node


def _prune(node: P.PlanNode, needed: set):
    """Returns (node', cmap) where node' produces a superset of
    ``needed ∪ node.pk`` of node's output columns (in original order)
    and cmap maps each kept original index to its new position."""
    needed = set(needed) | set(node.pk)

    if isinstance(node, P.PProject):
        kept = sorted(needed)
        child_req: set = set()
        for i in kept:
            child_req |= expr_refs(node.exprs[i])
        child, cc = _prune(node.input, child_req)
        exprs = tuple(remap_expr(node.exprs[i], cc) for i in kept)
        cmap = {o: n for n, o in enumerate(kept)}
        return dataclasses.replace(
            node, input=child, exprs=exprs,
            schema=node.schema.select(tuple(kept)),
            pk=tuple(cmap[p] for p in node.pk)), cmap

    if isinstance(node, P.PFilter):
        child, cc = _prune(node.input,
                           needed | set(expr_refs(node.predicate)))
        return dataclasses.replace(
            node, input=child, schema=child.schema,
            pk=tuple(cc[p] for p in node.pk),
            predicate=remap_expr(node.predicate, cc)), cc

    if isinstance(node, P.PJoin):
        nl = len(node.left.schema)
        cond_refs = expr_refs(node.condition) if node.condition is not None \
            else frozenset()
        lreq = ({i for i in needed if i < nl} | set(node.left_keys)
                | {i for i in cond_refs if i < nl})
        rreq = ({i - nl for i in needed if i >= nl}
                | set(node.right_keys)
                | {i - nl for i in cond_refs if i >= nl})
        lc, lcm = _prune(node.left, lreq)
        rc, rcm = _prune(node.right, rreq)
        nnl = len(lc.schema)
        cmap = {**{o: n for o, n in lcm.items()},
                **{o + nl: n + nnl for o, n in rcm.items()}}
        from ..common.types import Schema
        return dataclasses.replace(
            node, left=lc, right=rc,
            schema=Schema(tuple(lc.schema) + tuple(rc.schema)),
            pk=tuple(cmap[p] for p in node.pk),
            left_keys=tuple(lcm[k] for k in node.left_keys),
            right_keys=tuple(rcm[k] for k in node.right_keys),
            condition=(remap_expr(node.condition, cmap)
                       if node.condition is not None else None)), cmap

    if isinstance(node, P.PAgg):
        nk = len(node.group_keys)
        kept_aggs = sorted({i - nk for i in needed if i >= nk})
        child_req = set(node.group_keys) | {
            node.agg_calls[j].arg for j in kept_aggs
            if node.agg_calls[j].arg >= 0}
        child, cc = _prune(node.input, child_req)
        calls = tuple(
            dataclasses.replace(node.agg_calls[j],
                                arg=(cc[node.agg_calls[j].arg]
                                     if node.agg_calls[j].arg >= 0 else -1))
            for j in kept_aggs)
        from ..common.types import Schema
        fields = tuple(node.schema[i] for i in range(nk)) + tuple(
            node.schema[nk + j] for j in kept_aggs)
        cmap = {**_ident(nk),
                **{nk + j: nk + n for n, j in enumerate(kept_aggs)}}
        return dataclasses.replace(
            node, input=child, schema=Schema(fields),
            group_keys=tuple(cc[k] for k in node.group_keys),
            agg_calls=calls), cmap

    if isinstance(node, P.PTopN):
        req = (needed | {o.col for o in node.order} | set(node.group_by))
        child, cc = _prune(node.input, req)
        return dataclasses.replace(
            node, input=child, schema=child.schema,
            pk=tuple(cc[p] for p in node.pk),
            order=tuple(dataclasses.replace(o, col=cc[o.col])
                        for o in node.order),
            group_by=tuple(cc[g] for g in node.group_by)), cc

    if isinstance(node, P.PDynFilter):
        child, cc = _prune(node.input, needed | {node.key_col})
        right, _ = _prune(node.right, {0})
        return dataclasses.replace(
            node, input=child, right=right, schema=child.schema,
            pk=tuple(cc[p] for p in node.pk), key_col=cc[node.key_col]), cc

    if isinstance(node, (P.PSource, P.PTableScan, P.PMvScan, P.PValues)):
        kept = sorted(needed)
        if len(kept) == len(node.schema):
            return node, _ident(len(node.schema))
        cmap = {o: n for n, o in enumerate(kept)}
        proj = P.PProject(
            schema=node.schema.select(tuple(kept)),
            pk=tuple(cmap[p] for p in node.pk), input=node,
            exprs=tuple(InputRef(i, node.schema[i].type) for i in kept))
        return proj, cmap

    # conservative nodes (HopWindow / OverWindow / ProjectSet / Union /
    # TemporalJoin): all input columns stay live; recurse requiring all
    kids = [(_prune(k, set(range(len(k.schema))))) for k in node.children]
    if kids and any(k is not orig for (k, _), orig
                    in zip(kids, node.children)):
        node = _with_children(node, [k for k, _ in kids])
    return node, _ident(len(node.schema))


# -- entry --------------------------------------------------------------------


def optimize(plan: P.PlanNode) -> P.PlanNode:
    """The pass pipeline: pushdown stage to fixpoint, then column
    pruning, then a cleanup stage merging the projections pruning
    introduced (reference: logical_optimization.rs stage list)."""
    plan = rewrite_fixpoint(plan, PREPASS_RULES)
    plan = rewrite_fixpoint(plan, PUSHDOWN_RULES)
    plan = prune_columns(plan)
    plan = rewrite_fixpoint(plan, CLEANUP_RULES)
    return plan


def explain_text(plan: P.PlanNode) -> str:
    return plan.explain()
