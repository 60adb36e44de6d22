"""Copy of ``risingwave_tpu/frontend/binder.py``: the reference's text,
its relative imports resolving to the port's modules.

Binder: name resolution of AST expressions against a column scope.

Counterpart of the reference's Binder (reference: src/frontend/src/binder/
mod.rs:78,269). One deliberate simplification vs the reference: bound
expressions ARE the runtime expression objects (risingwave_tpu.expr) — there
is no separate frontend IR to re-lower, because the runtime exprs are
already pure plan-time trees that inline into jitted steps (expr/expr.py).
Aggregate calls are extracted (not evaluable row-wise) and replaced by
references into the agg operator's output.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..common.types import (
    BOOL, DATE, FLOAT64, INT32, INT64, INTERVAL, TIMESTAMP, VARCHAR,
    DataType, Field, Schema, TypeKind,
)


def _parse_date(s: str) -> int:
    """ISO date string → days since the Unix epoch (DATE physical)."""
    import datetime as _dt
    return (_dt.date.fromisoformat(s.strip()) - _dt.date(1970, 1, 1)).days


def _parse_timestamp(s: str) -> int:
    """ISO timestamp string (naive = UTC) → epoch microseconds (exact
    integer arithmetic; float seconds would drop microseconds)."""
    import datetime as _dt
    dt = _dt.datetime.fromisoformat(s.strip())
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
    return (dt - epoch) // _dt.timedelta(microseconds=1)
from ..expr.agg import AggCall
from ..expr.expr import Cast as RCast, Expr, InputRef, Literal, call, cast
from . import sqlast as A
from .catalog import type_from_name


class BindError(ValueError):
    pass


@dataclasses.dataclass
class ScopeColumn:
    name: str
    table: Optional[str]
    index: int
    type: DataType


class Scope:
    """Visible columns during binding, with table-alias qualification."""

    def __init__(self, columns: Sequence[ScopeColumn]):
        self.columns = list(columns)

    @staticmethod
    def of_schema(schema: Schema, table: Optional[str] = None,
                  offset: int = 0) -> "Scope":
        return Scope([
            ScopeColumn(f.name, table, offset + i, f.type)
            for i, f in enumerate(schema)
        ])

    def concat(self, other: "Scope", offset: int) -> "Scope":
        """``offset``: width of the left relation's SCHEMA (not scope — a
        scope may hide internal pk columns, but indices address the schema)."""
        return Scope(self.columns + [
            dataclasses.replace(c, index=c.index + offset)
            for c in other.columns
        ])

    def resolve(self, name: str, table: Optional[str]) -> ScopeColumn:
        matches = [
            c for c in self.columns
            if c.name == name and (table is None or c.table == table)
        ]
        if not matches:
            raise BindError(f"column {table + '.' if table else ''}{name} not found")
        if len(matches) > 1:
            raise BindError(f"column reference {name!r} is ambiguous")
        return matches[0]


_BINOP_FN = {
    "+": "add", "-": "subtract", "*": "multiply", "/": "divide",
    "%": "modulus", "=": "equal", "<>": "not_equal", "<": "less_than",
    "<=": "less_than_or_equal", ">": "greater_than",
    ">=": "greater_than_or_equal", "AND": "and", "OR": "or",
    "||": "concat_op", "LIKE": "like", "NOT LIKE": "not_like",
}

AGG_KINDS = {"count", "sum", "min", "max", "avg",
             "approx_count_distinct",
             # materialized-input kinds (stream/materialized_agg.py)
             "array_agg", "string_agg", "percentile_cont", "mode"}

#: aggs taking a constant second argument, stored on AggCall.extra
_EXTRA_ARG_AGGS = {"string_agg", "percentile_cont"}

RANK_FUNC_KINDS = {"row_number", "rank", "dense_rank"}
WINDOW_ONLY_KINDS = RANK_FUNC_KINDS | {"lag", "lead"}


@dataclasses.dataclass
class BoundAgg:
    """An aggregate call found during binding + where its output will land."""

    call: AggCall
    output_index: int     # index in the agg operator's output (after keys)


@dataclasses.dataclass
class BoundWindow:
    """A window function call found during binding (planner turns the set
    of these into one POverWindow node; all calls must share the same
    PARTITION BY / ORDER BY)."""

    kind: str
    output_type: DataType
    arg_expr: Optional[Expr]           # lag/lead/agg argument
    offset: int                        # lag/lead distance
    partition_exprs: tuple             # Expr...
    order_exprs: tuple                 # (Expr, desc, nulls_last)...


def _const_int(e: Expr) -> Optional[int]:
    """Constant-fold an integer literal (incl. unary minus)."""
    from ..expr.expr import FunctionCall
    if isinstance(e, Literal) and e.value is not None:
        return int(e.value)
    if (isinstance(e, FunctionCall) and e.name == "neg"
            and len(e.args) == 1 and isinstance(e.args[0], Literal)
            and e.args[0].value is not None):
        return -int(e.args[0].value)
    return None


class ExprBinder:
    """Binds one expression tree. ``agg_ctx`` non-None => aggregate calls are
    allowed and collected (SELECT/HAVING position in a GROUP BY query)."""

    def __init__(self, scope: Scope, agg_ctx: Optional[list] = None,
                 subquery_sink: Optional[list] = None,
                 win_ctx: Optional[list] = None):
        self.scope = scope
        self.agg_ctx = agg_ctx
        self.subquery_sink = subquery_sink
        self.win_ctx = win_ctx

    def bind(self, node) -> Expr:
        if isinstance(node, A.ColumnRef):
            c = self.scope.resolve(node.name, node.table)
            return InputRef(c.index, c.type)
        if isinstance(node, A.Lit):
            return self._literal(node)
        if isinstance(node, A.BinaryOp):
            return self._binop(node)
        if isinstance(node, A.UnaryOp):
            if node.op == "NOT":
                return call("not", self.bind(node.operand))
            if node.op == "-":
                b = self.bind(node.operand)
                if isinstance(b, Literal) and b.value is not None:
                    return Literal(-b.value, b.type)
                return call("neg", b)
            raise BindError(f"unsupported unary op {node.op}")
        if isinstance(node, A.FuncCall):
            return self._func(node)
        if isinstance(node, A.Case):
            args = []
            for cond, res in node.branches:
                args.append(self.bind(cond))
                args.append(self.bind(res))
            if node.else_result is not None:
                args.append(self.bind(node.else_result))
            return call("case", *args)
        if isinstance(node, A.InList):
            e = self.bind(node.expr)
            cmps = [call("equal", e, self.bind(i)) for i in node.items]
            out = cmps[0]
            for c in cmps[1:]:
                out = call("or", out, c)
            return call("not", out) if node.negated else out
        if isinstance(node, A.Between):
            e = self.bind(node.expr)
            lo = call("greater_than_or_equal", e, self.bind(node.low))
            hi = call("less_than_or_equal", e, self.bind(node.high))
            rng = call("and", lo, hi)
            return call("not", rng) if node.negated else rng
        if isinstance(node, A.IsNull):
            fn = "is_not_null" if node.negated else "is_null"
            return call(fn, self.bind(node.expr))
        if isinstance(node, A.Cast):
            return cast(self.bind(node.expr), type_from_name(node.type_name))
        if isinstance(node, A.WindowFunc):
            return self._bind_window(node)
        if isinstance(node, A.ArrayLit):
            items = [self.bind(it) for it in node.items]
            if not all(isinstance(it, Literal) for it in items):
                raise BindError("ARRAY[…] elements must be constants")
            # unify element types: ints widen to INT64, any float makes
            # the whole array FLOAT64; mixed classes are a bind error
            kinds = {it.type.kind for it in items if it.value is not None}
            int_kinds = {TypeKind.INT16, TypeKind.INT32, TypeKind.INT64}
            float_kinds = {TypeKind.FLOAT32, TypeKind.FLOAT64}
            if not kinds:
                elem_kind = TypeKind.INT64
            elif kinds <= int_kinds:
                elem_kind = TypeKind.INT64
            elif kinds <= int_kinds | float_kinds:
                elem_kind = TypeKind.FLOAT64
            elif len(kinds) == 1:
                elem_kind = next(iter(kinds))
            else:
                raise BindError(
                    "ARRAY[…] elements must share one type; got "
                    + ", ".join(sorted(k.value for k in kinds)))
            conv = (float if elem_kind == TypeKind.FLOAT64 else
                    int if elem_kind == TypeKind.INT64 else
                    (lambda v: v))
            return Literal(
                tuple(None if it.value is None else conv(it.value)
                      for it in items),
                DataType(TypeKind.LIST, elem_kind=elem_kind))
        if isinstance(node, A.Subscript):
            return self._bind_subscript(node)
        if isinstance(node, A.FieldAccess):
            base = self.bind(node.expr)
            if not base.type.is_struct:
                raise BindError(
                    f"cannot access field {node.field!r} of a "
                    f"{base.type.kind.value} value")
            from ..expr.expr import FunctionCall as RFunctionCall
            idx = base.type.field_index(node.field)
            return RFunctionCall(
                "struct_field",
                (base, Literal(idx, INT64)),
                base.type.field_type(node.field))
        if isinstance(node, A.ScalarSubquery):
            if self.subquery_sink is None:
                raise BindError("scalar subquery not supported here")
            self.subquery_sink.append(node.query)
            # placeholder: planner rewrites the comparison into DynamicFilter
            return _SubqueryPlaceholder(len(self.subquery_sink) - 1)
        raise BindError(f"cannot bind {type(node).__name__}")

    def _bind_subscript(self, node: A.Subscript) -> Expr:
        """1-based element access. (regexp_match(s, p))[n] is rewritten to
        the scalar regexp_match_group(s, p, n) — the match-groups array
        never materializes (PG semantics: regexp_match returns text[] of
        capture groups; reference: src/expr/src/vector_op/regexp.rs)."""
        idx = self.bind(node.index)
        if (isinstance(node.expr, A.FuncCall)
                and node.expr.name.lower() == "regexp_match"):
            args = [self.bind(a) for a in node.expr.args]
            return call("regexp_match_group", *args, idx)
        base = self.bind(node.expr)
        if not base.type.is_list:
            raise BindError(
                f"cannot subscript a {base.type.kind.value} value")
        return call("array_access", base, idx)

    def _literal(self, node: A.Lit) -> Literal:
        v = node.value
        if v is None:
            return Literal(None, INT64)
        if node.type_hint == "interval":
            return Literal(v, INTERVAL)
        if node.type_hint == "varchar":
            return Literal(v, VARCHAR)
        if node.type_hint == "date":
            return Literal(_parse_date(str(v)), DATE)
        if node.type_hint == "timestamp":
            return Literal(_parse_timestamp(str(v)), TIMESTAMP)
        if isinstance(v, bool):
            return Literal(v, BOOL)
        if isinstance(v, int):
            return Literal(v, INT64 if abs(v) > 2**31 - 1 else INT32)
        if isinstance(v, float):
            return Literal(v, FLOAT64)
        raise BindError(f"cannot bind literal {v!r}")

    def _binop(self, node: A.BinaryOp) -> Expr:
        if node.op in ("->", "->>"):
            left = self.bind(node.left)
            right = self.bind(node.right)
            if left.type.kind != TypeKind.JSONB:
                raise BindError(
                    f"{node.op} requires a jsonb left operand; got "
                    f"{left.type.kind.value}")
            text = node.op == "->>"
            if right.type.kind == TypeKind.VARCHAR:
                fn = "jsonb_get_field_text" if text else "jsonb_get_field"
            elif right.type.is_integral:
                fn = "jsonb_get_elem_text" if text else "jsonb_get_elem"
            else:
                # is_string also covers JSONB/BYTEA — their serialized
                # text silently used as a key would mask a type error
                raise BindError(f"{node.op} key must be text or integer")
            return call(fn, left, right)
        fn = _BINOP_FN.get(node.op)
        if fn is None:
            raise BindError(f"unsupported operator {node.op}")
        left, right = self.bind(node.left), self.bind(node.right)
        if fn in ("concat_op", "like", "not_like"):
            # the impls interpret values as dictionary ids — a non-string
            # operand would silently decode garbage
            for side in (left, right):
                if not side.type.is_string:
                    raise BindError(
                        f"{node.op} requires varchar operands; got "
                        f"{side.type.kind.value} (cast to varchar first)")
        return call(fn, left, right)

    def _func(self, node: A.FuncCall) -> Expr:
        name = node.name.lower()
        if name in WINDOW_ONLY_KINDS:
            raise BindError(f"{name}() requires an OVER clause")
        from ..stream.project_set import TABLE_FUNC_KINDS, TableFuncCall
        if name in TABLE_FUNC_KINDS:
            args = tuple(self.bind(a) for a in node.args)
            from ..common.types import VARCHAR as _VC
            if name == "regexp_split_to_table":
                out_t = _VC
            elif name == "unnest":
                if not args or not args[0].type.is_list:
                    raise BindError("unnest() requires an array argument")
                out_t = args[0].type.elem_type
            else:
                out_t = INT64
            return TableFuncCall(name, args, out_t)
        if name == "extract":
            from ..expr.expr import make_extract
            field = node.args[0]
            assert isinstance(field, A.Lit)
            return make_extract(str(field.value), self.bind(node.args[1]))
        if name == "row":
            # ROW(c1, c2, …) composite constructor; PG names fields f1…fn
            items = [self.bind(a) for a in node.args]
            # const-fold a literal cast (ROW(1.23::decimal)) so the field
            # carries the cast's target type, scale included. Only a
            # VALUE-PRESERVING cast folds: a lossy one (1.9::bigint,
            # 1::varchar) would need the runtime Cast's rounding rules,
            # so it falls through to the constants check below instead of
            # silently diverging from `SELECT 1.9::bigint`
            def _fold(it: Expr) -> Expr:
                if not (isinstance(it, RCast)
                        and isinstance(it.arg, Literal)):
                    return it
                if it.arg.value is None:
                    return Literal(None, it.type)
                try:
                    v = it.type.to_python(it.type.to_physical(it.arg.value))
                    if v != it.arg.value:
                        return it
                except Exception:
                    return it
                return Literal(v, it.type)

            items = [_fold(it) for it in items]
            if not all(isinstance(it, Literal) for it in items):
                raise BindError("ROW(…) fields must be constants")
            from ..common.types import struct_of
            # full DataTypes, not bare kinds: decimal scale and list
            # element types must survive into the struct's field types or
            # field access / persistence decode at the wrong scale
            t = struct_of(*((f"f{i + 1}", it.type)
                            for i, it in enumerate(items)))
            return Literal(tuple(it.value for it in items), t)
        if name in AGG_KINDS:
            if self.agg_ctx is None:
                raise BindError(f"aggregate {name}() not allowed here")
            return self._bind_agg(name, node)
        args = [self.bind(a) for a in node.args]
        return call(name, *args)

    def _bind_window(self, node: A.WindowFunc) -> Expr:
        if self.win_ctx is None:
            raise BindError("window functions are not allowed here")
        kind = node.func.name.lower()
        if kind not in WINDOW_ONLY_KINDS | AGG_KINDS:
            raise BindError(f"{kind}() is not a window function")
        plain = ExprBinder(self.scope)
        args = [plain.bind(a) for a in node.func.args
                if not isinstance(a, A.Star)]
        arg_expr: Optional[Expr] = None
        offset = 1
        if kind in RANK_FUNC_KINDS:
            if args:
                raise BindError(f"{kind}() takes no arguments")
            out_t = INT64
        elif kind in ("lag", "lead"):
            if not 1 <= len(args) <= 2:
                raise BindError(f"{kind}(value [, offset]) expected")
            arg_expr = args[0]
            if len(args) == 2:
                off = _const_int(args[1])
                if off is None:
                    raise BindError(f"{kind}() offset must be a literal")
                if off < 0:
                    raise BindError(
                        f"{kind}() offset must be non-negative")
                offset = off
            out_t = arg_expr.type
        else:   # windowed aggregate
            if kind == "count" and not args:
                out_t = INT64
            else:
                if len(args) != 1:
                    raise BindError(f"{kind}() takes one argument")
                arg_expr = args[0]
                if arg_expr.type.is_string and kind != "count":
                    raise BindError(
                        f"window {kind}() over varchar is unsupported")
                out_t = AggCall(kind, -1, arg_expr.type).output_type
        partition = tuple(plain.bind(p) for p in node.partition_by)
        order = tuple(
            (plain.bind(oi.expr), oi.desc,
             oi.nulls_last if oi.nulls_last is not None else not oi.desc)
            for oi in node.order_by)
        bw = BoundWindow(kind, out_t, arg_expr, offset, partition, order)
        self.win_ctx.append(bw)
        return _WindowPlaceholder(len(self.win_ctx) - 1, out_t)

    def _bind_agg(self, kind: str, node: A.FuncCall) -> Expr:
        extra = None
        if kind in _EXTRA_ARG_AGGS:
            if len(node.args) != 2:
                raise BindError(
                    f"{kind}(value, constant) takes two arguments")
            const = self.bind(node.args[1])
            if not isinstance(const, Literal):
                raise BindError(f"{kind}()'s second argument must be a "
                                "constant")
            extra = const.value
            node = dataclasses.replace(node, args=node.args[:1])
        if len(node.args) > 1:
            raise BindError(f"{kind}() takes at most one argument")
        if node.filter is not None:
            # FILTER (WHERE c) rewrites to a CASE-wrapped argument: rows
            # failing c contribute NULL, which the aggregates here skip
            # (count counts non-NULL). count(*) FILTER (c) == count(CASE
            # WHEN c THEN 1 END). Works under DISTINCT too: distinct-ness
            # is over the surviving non-NULL values. (reference:
            # src/frontend/src/optimizer/plan_node/logical_agg.rs agg
            # filter support.) array_agg is the one NULL-KEEPING
            # aggregate — the rewrite would turn excluded rows into NULL
            # elements — so it is rejected rather than silently wrong.
            if kind == "array_agg":
                raise BindError(
                    "FILTER on array_agg is not supported (array_agg "
                    "keeps NULL elements; filter in a subquery instead)")
            if not node.args or isinstance(node.args[0], A.Star):
                if kind != "count":
                    raise BindError(f"{kind}(*) is not valid")
                wrapped: tuple = (A.Case(((node.filter, A.Lit(1)),), None),)
            else:
                wrapped = (A.Case(((node.filter, node.args[0]),), None),)
            node = dataclasses.replace(node, args=wrapped, filter=None)
        if not node.args or isinstance(node.args[0], A.Star):
            if kind != "count":
                raise BindError(f"{kind}(*) is not valid")
            acall = AggCall("count", -1, distinct=node.distinct)
        else:
            arg = ExprBinder(self.scope).bind(node.args[0])
            if not isinstance(arg, InputRef):
                # non-trivial agg args get a pre-projection by the planner;
                # record the expression itself
                acall = AggCall(kind, -2, arg.type, distinct=node.distinct,
                                extra=extra)
                bound = BoundAgg(acall, -1)
                bound.arg_expr = arg  # type: ignore[attr-defined]
                self.agg_ctx.append(bound)
                return _AggPlaceholder(len(self.agg_ctx) - 1, acall.output_type)
            acall = AggCall(kind, arg.index, arg.type, distinct=node.distinct,
                            extra=extra)
        # dedup identical agg calls
        for i, b in enumerate(self.agg_ctx):
            if b.call == acall and not hasattr(b, "arg_expr"):
                return _AggPlaceholder(i, acall.output_type)
        self.agg_ctx.append(BoundAgg(acall, -1))
        return _AggPlaceholder(len(self.agg_ctx) - 1, acall.output_type)


@dataclasses.dataclass(frozen=True, eq=False)
class _AggPlaceholder(Expr):
    """Stands for 'output of agg call #i'; the planner rewrites it to an
    InputRef over the agg operator's output schema."""

    agg_index: int
    type: DataType

    def eval(self, chunk):  # pragma: no cover
        raise RuntimeError("unresolved aggregate placeholder")


@dataclasses.dataclass(frozen=True, eq=False)
class _WindowPlaceholder(Expr):
    """Stands for 'output of window call #i'; the planner rewrites it to an
    InputRef over the over-window operator's output schema."""

    win_index: int
    type: DataType

    def eval(self, chunk):  # pragma: no cover
        raise RuntimeError("unresolved window placeholder")


@dataclasses.dataclass(frozen=True, eq=False)
class _SubqueryPlaceholder(Expr):
    """Stands for 'the scalar value of subquery #i' inside WHERE — only
    allowed as one side of a comparison, which the planner turns into a
    DynamicFilter (reference: dynamic_filter.rs pattern)."""

    subquery_index: int
    type: DataType = INT64

    def eval(self, chunk):  # pragma: no cover
        raise RuntimeError("unresolved subquery placeholder")


def rewrite_placeholders(e: Expr, mapping) -> Expr:
    """Replace _AggPlaceholder nodes via ``mapping(agg_index) -> Expr``."""
    from ..expr.expr import FunctionCall
    if isinstance(e, _AggPlaceholder):
        return mapping(e.agg_index)
    if isinstance(e, FunctionCall):
        new_args = tuple(rewrite_placeholders(a, mapping) for a in e.args)
        return dataclasses.replace(e, args=new_args)
    if isinstance(e, RCast):
        return dataclasses.replace(e, arg=rewrite_placeholders(e.arg, mapping))
    return e


def contains_placeholder(e: Expr, kind) -> bool:
    from ..expr.expr import FunctionCall
    if isinstance(e, kind):
        return True
    if isinstance(e, FunctionCall):
        return any(contains_placeholder(a, kind) for a in e.args)
    if isinstance(e, RCast):
        return contains_placeholder(e.arg, kind)
    return False
